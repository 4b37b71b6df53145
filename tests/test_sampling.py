"""Statistical sampler tests — SURVEY §4 item 1/2 (chi-square-style checks
against the analytic pdfs of CudaTracer.cu:533-577)."""
import jax
import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.ops.sampling import (
    beckmann_direction, lambert_direction, phong_direction, rotate_y_to)
from cuda_path_tracer_ss.ops.vec import Vec3

N = 200_000


def _uniforms(seed, n=N):
    u = jax.random.uniform(jax.random.PRNGKey(seed), (2, n))
    return u[0], u[1]


def _normal(vals, n=N):
    return Vec3.full((n,), vals)


def test_rotate_y_to_maps_axis():
    targets = Vec3.from_array(jnp.asarray(
        [[0, 1, 0], [1, 0, 0], [0, 0, -1], [0, -1, 0],
         [0.6, 0.8, 0.0]], jnp.float32))
    y = Vec3.full((5,), (0.0, 1.0, 0.0))
    out = rotate_y_to(targets, y).to_array()
    np.testing.assert_allclose(out, targets.to_array(), atol=1e-6)


def test_rotate_preserves_length():
    u1, u2 = _uniforms(1, 1000)
    tgt = lambert_direction(_normal((0, 1, 0), 1000), u1, u2)  # random unit dirs
    sample = Vec3.full((1000,), (0.3, 0.5, np.sqrt(1 - 0.09 - 0.25)))
    out = rotate_y_to(tgt, sample)
    np.testing.assert_allclose(np.asarray(out.norm()), 1.0, atol=1e-5)


def test_lambert_cosine_distribution():
    u1, u2 = _uniforms(2)
    n = _normal((0, 1, 0))
    d = lambert_direction(n, u1, u2)
    cos = np.asarray(d.y)
    assert np.all(cos >= -1e-6)
    # cosine-weighted: E[cos] = 2/3, E[cos^2] = 1/2
    assert abs(cos.mean() - 2 / 3) < 5e-3
    assert abs((cos ** 2).mean() - 0.5) < 5e-3
    # azimuthal symmetry
    assert abs(np.asarray(d.x).mean()) < 5e-3
    assert abs(np.asarray(d.z).mean()) < 5e-3


def test_lambert_arbitrary_frame():
    u1, u2 = _uniforms(3)
    axis = np.array([1.0, -2.0, 0.5])
    axis /= np.linalg.norm(axis)
    n = _normal(tuple(axis))
    d = lambert_direction(n, u1, u2)
    cos = np.asarray(d.to_array() @ axis)
    assert np.all(cos >= -1e-5)
    assert abs(cos.mean() - 2 / 3) < 5e-3


def test_phong_exponent_moments():
    u1, u2 = _uniforms(4)
    axis = _normal((0, 1, 0))
    for exp in [1.0, 10.0, 100.0]:
        d = phong_direction(axis, jnp.float32(exp), u1, u2)
        cos = np.asarray(d.y)
        # y = u^(1/(e+1)) => E[y] = (e+1)/(e+2)
        assert abs(cos.mean() - (exp + 1) / (exp + 2)) < 5e-3, exp


def test_phong_infinite_exponent_is_mirror():
    u1, u2 = _uniforms(5, 100)
    axis = _normal((0, 0, 1), 100)
    d = phong_direction(axis, jnp.float32(np.inf), u1, u2)
    np.testing.assert_allclose(d.to_array(), axis.to_array(), atol=1e-6)


def test_beckmann_theta_distribution():
    u1, u2 = _uniforms(6)
    n = _normal((0, 1, 0))
    for rough in [0.1, 0.3, 0.6]:
        m = beckmann_direction(n, jnp.float32(rough), u1, u2)
        cos = np.clip(np.asarray(m.y), -1, 1)
        tan2 = (1 - cos ** 2) / np.maximum(cos ** 2, 1e-12)
        # theta = atan(-m^2 ln(1-u)) => tan^2(theta)/m^4 = ln(1-u)^2;
        # E[ln(1-U)^2] = 2 for U~U(0,1)
        assert abs(tan2.mean() / rough ** 4 - 2.0) < 0.15, rough


def test_beckmann_zero_roughness_is_normal():
    u1, u2 = _uniforms(7, 100)
    n = _normal((0.6, 0.8, 0.0), 100)
    m = beckmann_direction(n, jnp.float32(0.0), u1, u2)
    np.testing.assert_allclose(m.to_array(), n.to_array(), atol=1e-6)


def test_antipodal_target_no_nan():
    u1, u2 = _uniforms(8, 100)
    n = _normal((0, -1, 0), 100)
    d = lambert_direction(n, u1, u2)
    arr = d.to_array()
    assert np.all(np.isfinite(arr))
    assert np.all(np.asarray(d.y) <= 1e-6)  # hemisphere about -Y
