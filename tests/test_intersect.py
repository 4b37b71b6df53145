import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.models.scene import MaterialSpec, SceneBuilder
from cuda_path_tracer_ss.ops.intersect import (
    any_hit, nearest_hit, sphere_t, surfel_at, triangle_t)
from cuda_path_tracer_ss.ops.vec import Vec3


def _rays(origins, directions):
    o = np.asarray(origins, np.float32).reshape(-1, 3)
    d = np.asarray(directions, np.float32).reshape(-1, 3)
    return Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d))


def test_sphere_outside_inside_miss():
    # Mirrors the t0/t1/inside cases of Primitives.h:126-174.
    ro, rd = _rays(
        [[0, 0, 5], [0, 0, 0], [0, 3, 5]],
        [[0, 0, -1], [0, 0, -1], [0, 0, -1]],
    )
    t, valid = sphere_t(ro, rd, 0.0, 0.0, 0.0, 1.0)
    t, valid = np.asarray(t), np.asarray(valid)
    assert valid[0] and np.isclose(t[0], 4.0)       # outside: near root
    assert valid[1] and np.isclose(t[1], 1.0)       # inside: far root
    assert not valid[2]                             # miss


def test_sphere_behind_ray():
    ro, rd = _rays([[0, 0, -5]], [[0, 0, -1]])
    _, valid = sphere_t(ro, rd, 0.0, 0.0, 0.0, 1.0)
    assert not bool(np.asarray(valid)[0])


def test_triangle_hit_and_edges():
    v0 = Vec3(jnp.float32(0), jnp.float32(0), jnp.float32(0))
    v1 = Vec3(jnp.float32(1), jnp.float32(0), jnp.float32(0))
    v2 = Vec3(jnp.float32(0), jnp.float32(1), jnp.float32(0))
    ro, rd = _rays(
        [[0.25, 0.25, 1], [0.5, 0.5, 1], [0.75, 0.75, 1], [0, 0, 1], [0.25, 0.25, -1]],
        [[0, 0, -1]] * 5,
    )
    t, w1, w2, valid = triangle_t(ro, rd, v0, v1, v2)
    valid = np.asarray(valid)
    assert valid[0]                                  # interior
    assert valid[1]                                  # hypotenuse edge (w0 == 0)
    assert not valid[2]                              # outside
    assert valid[3]                                  # vertex graze
    assert not valid[4]                              # behind (t < 0)
    np.testing.assert_allclose(np.asarray(t)[0], 1.0, rtol=1e-6)
    np.testing.assert_allclose([np.asarray(w1)[0], np.asarray(w2)[0]], [0.25, 0.25], atol=1e-6)


def test_parallel_ray_rejected():
    v0 = Vec3(jnp.float32(0), jnp.float32(0), jnp.float32(0))
    v1 = Vec3(jnp.float32(1), jnp.float32(0), jnp.float32(0))
    v2 = Vec3(jnp.float32(0), jnp.float32(1), jnp.float32(0))
    ro, rd = _rays([[0.2, 0.2, 1]], [[1, 0, 0]])
    *_, valid = triangle_t(ro, rd, v0, v1, v2)
    assert not bool(np.asarray(valid)[0])


def _two_prim_scene():
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(1, 1, 1), diff_avg=0.5))
    b.add_sphere((0, 0, -3), 1.0, m)
    b.add_triangle((-5, -5, -6), (5, -5, -6), (0, 5, -6),
                   (0, 0, 1), (0, 0, 1), (0, 0, 1), m)
    return b.build()


def test_nearest_hit_prefers_closer():
    scene = _two_prim_scene()
    ro, rd = _rays([[0, 0, 0], [2, 0, 0]], [[0, 0, -1], [0, 0, -1]])
    hit = nearest_hit(ro, rd, scene)
    t = np.asarray(hit.t)
    assert np.isclose(t[0], 2.0)         # sphere in front of the triangle
    assert np.isclose(t[1], 6.0)         # only the triangle
    prim = np.asarray(hit.prim)
    assert prim[0] == 0 and prim[1] == 1  # sphere id 0, triangle id S+0 = 1

    surf = surfel_at(ro, rd, hit, scene)
    np.testing.assert_allclose(
        [float(surf.normal.x[0]), float(surf.normal.y[0]), float(surf.normal.z[0])],
        [0, 0, 1], atol=1e-6)


def test_any_hit_occlusion():
    scene = _two_prim_scene()
    ro, rd = _rays([[0, 0, 0], [2, 0, 0]], [[0, 0, -1], [0, 0, -1]])
    occ_near = np.asarray(any_hit(ro, rd, 10.0, scene))
    assert occ_near.tolist() == [True, True]
    occ_short = np.asarray(any_hit(ro, rd, 1.5, scene))
    assert occ_short.tolist() == [False, False]


def test_miss_everything():
    scene = _two_prim_scene()
    ro, rd = _rays([[0, 0, 0]], [[0, 0, 1]])
    hit = nearest_hit(ro, rd, scene)
    assert not bool(np.asarray(hit.hit)[0])
