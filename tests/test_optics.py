import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.ops.optics import (
    fresnel_reflectance, media_and_sin_t2, reflect_abs, reflect_signed, refract)
from cuda_path_tracer_ss.ops.vec import Vec3


def test_media_selection_outside_inside():
    ior = jnp.asarray([1.5, 1.5])
    cos_i = jnp.asarray([0.8, -0.8])  # outside, inside
    cos_pos, sin_t2, n1, n2, n = media_and_sin_t2(ior, cos_i)
    np.testing.assert_allclose(np.asarray(cos_pos), [0.8, 0.8])
    np.testing.assert_allclose(np.asarray(n1), [1.0, 1.5])
    np.testing.assert_allclose(np.asarray(n2), [1.5, 1.0])
    np.testing.assert_allclose(np.asarray(n), [1 / 1.5, 1.5], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sin_t2), [(1 / 1.5) ** 2 * 0.36, 1.5 ** 2 * 0.36],
                               rtol=1e-5)


def test_fresnel_normal_incidence():
    # At normal incidence F = ((n1-n2)/(n1+n2))^2 = 0.04 for n=1.5.
    cos_pos = jnp.asarray([1.0])
    ior = jnp.asarray([1.5])
    cos_i = jnp.asarray([1.0])
    cp, sin_t2, n1, n2, _ = media_and_sin_t2(ior, cos_i)
    f = fresnel_reflectance(cp, sin_t2, n1, n2)
    np.testing.assert_allclose(np.asarray(f), [0.04], rtol=1e-4)


def test_fresnel_grazing_and_tir():
    ior = jnp.asarray([1.5, 1.5])
    cos_i = jnp.asarray([1e-4, -0.5])  # grazing from outside; inside at 60deg
    cp, sin_t2, n1, n2, _ = media_and_sin_t2(ior, cos_i)
    f = np.asarray(fresnel_reflectance(cp, sin_t2, n1, n2))
    assert f[0] > 0.99          # grazing -> ~1
    assert f[1] == 1.0          # TIR: sin_t2 = 2.25*0.75 > 1


def test_reflect_signed():
    d = Vec3.from_array(jnp.asarray([[0.0, -1.0, 0.0]]))
    n = Vec3.from_array(jnp.asarray([[0.0, 1.0, 0.0]]))
    cos_i = (-d).dot(n)
    r = reflect_signed(d, n, cos_i)
    np.testing.assert_allclose(r.to_array(), [[0, 1, 0]], atol=1e-6)

    d45 = Vec3.from_array(jnp.asarray([[np.sqrt(0.5), -np.sqrt(0.5), 0.0]], jnp.float32))
    r45 = reflect_signed(d45, n, (-d45).dot(n))
    np.testing.assert_allclose(r45.to_array(), [[np.sqrt(0.5), np.sqrt(0.5), 0]], rtol=1e-5)


def test_reflect_abs_matches_signed_for_outside():
    d = Vec3.from_array(jnp.asarray([[0.6, -0.8, 0.0]]))
    n = Vec3.from_array(jnp.asarray([[0.0, 1.0, 0.0]]))
    np.testing.assert_allclose(
        reflect_abs(d, n).to_array(),
        reflect_signed(d, n, (-d).dot(n)).to_array(), atol=1e-6)


def test_refract_snell():
    # 45 deg into n=1.5: sin_t = sin(45)/1.5.
    d = Vec3.from_array(jnp.asarray([[np.sqrt(0.5), -np.sqrt(0.5), 0.0]], jnp.float32))
    n = Vec3.from_array(jnp.asarray([[0.0, 1.0, 0.0]]))
    cos_i = (-d).dot(n)
    cp, sin_t2, n1, n2, nr = media_and_sin_t2(jnp.asarray([1.5]), cos_i)
    w = refract(d, n, cp, sin_t2, nr)
    sin_t = np.sqrt(0.5) / 1.5
    np.testing.assert_allclose(np.asarray(w.x), [sin_t], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(w.y), [-np.sqrt(1 - sin_t ** 2)], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(w.norm()), [1.0], rtol=1e-6)
