"""Camera quaternion/movement tests — C14 parity (CudaTracer.cu:822-870)."""
import math

import numpy as np

from cuda_path_tracer_ss.models.camera import (
    Camera, quat_from_euler, quat_mul, quat_rotate, quat_to_matrix)
from cuda_path_tracer_ss.render.integrator import camera_arrays, eye_rays_for_indices

import jax.numpy as jnp


def test_default_camera_matches_reference():
    c = Camera()
    np.testing.assert_array_equal(c.position, [0, 0, 0])
    assert c.z_near == -0.1 and c.fov == math.pi / 2


def test_move_keys_translate_in_camera_space():
    c = Camera()
    assert c.move("w")
    np.testing.assert_allclose(c.position, [0, 0, -0.2], atol=1e-6)
    assert c.move("d")
    np.testing.assert_allclose(c.position, [0.2, 0, -0.2], atol=1e-6)
    assert c.move("q")
    np.testing.assert_allclose(c.position, [0.2, 0.2, -0.2], atol=1e-6)
    assert not c.move("x")


def test_rotation_then_forward_moves_along_view():
    c = Camera()
    for _ in range(9):  # 90 degrees left in 10-degree steps
        c.move("f")
    c.move("w")  # forward should now be -x
    np.testing.assert_allclose(c.position, [-0.2, 0, 0], atol=1e-5)


def test_quat_roundtrip():
    q = quat_from_euler((0.3, -0.7, 0.2))
    m = quat_to_matrix(q)
    v = np.array([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(m @ v, quat_rotate(q, v), rtol=1e-6)
    # rotation matrices are orthonormal
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-6)


def test_quat_mul_composition():
    a = quat_from_euler((0.4, 0, 0))
    b = quat_from_euler((0.3, 0, 0))
    np.testing.assert_allclose(quat_to_matrix(quat_mul(a, b)),
                               quat_to_matrix(quat_from_euler((0.7, 0, 0))),
                               atol=1e-6)


def test_eye_ray_center_looks_down_minus_z():
    cp = camera_arrays(Camera())
    # center pixel, no jitter offset beyond 0.5
    idx = jnp.asarray([0], jnp.int32)
    # 1x1 image: pixel center at (0.5, 0.5) -> screen center
    o, d = eye_rays_for_indices(cp, 1, 1, idx,
                                jnp.asarray([0.5]), jnp.asarray([0.5]))
    np.testing.assert_allclose(
        [float(d.x[0]), float(d.y[0]), float(d.z[0])], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(
        [float(o.x[0]), float(o.y[0]), float(o.z[0])], [0, 0, 0], atol=1e-7)


def test_eye_ray_fov_extent():
    # pi/2 fov: the image edge ray is 45 degrees off-axis horizontally
    cp = camera_arrays(Camera())
    idx = jnp.asarray([0], jnp.int32)
    o, d = eye_rays_for_indices(cp, 2, 2, idx,
                                jnp.asarray([0.0]), jnp.asarray([1.0]))
    # pixel 0 with zero jitter: screen x = 0/2 - 0.5 = the image's left edge
    # -> |x/z| = tan(fov/2) = 1
    ratio = abs(float(d.x[0]) / float(d.z[0]))
    np.testing.assert_allclose(ratio, 1.0, rtol=1e-5)
