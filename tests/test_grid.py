"""Uniform-grid acceleration (ops/grid.py) — the structure the reference
left as a TODO (CudaTracer/CudaTracer.cu:437). The grid is a pure speed
knob: every test here asserts it changes NOTHING about the image or the
hit/occlusion answers in the jnp engine (scan and while-loop marches), and
that gradients keep flowing through the gathered DDA path."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.ops import intersect
from cuda_path_tracer_ss.ops.grid import (UniformGrid, any_hit_grid,
                                              build_grid, max_steps,
                                              nearest_hit_grid)
from cuda_path_tracer_ss.ops.vec import Vec3
from cuda_path_tracer_ss.render import integrator

def _random_rays(scene_lo, scene_hi, n, seed):
    r = np.random.RandomState(seed)
    lo, hi = np.asarray(scene_lo), np.asarray(scene_hi)
    span = hi - lo
    # origins inside AND outside the grid AABB; unnormalized-safe directions
    o = lo - 0.5 * span + r.rand(n, 3) * 2.0 * span
    d = r.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = Vec3(*(jnp.asarray(o[:, a], jnp.float32) for a in range(3)))
    rd = Vec3(*(jnp.asarray(d[:, a], jnp.float32) for a in range(3)))
    return ro, rd


def _scene_bounds(grid: UniformGrid):
    lo = np.asarray(grid.origin)
    hi = lo + np.asarray(grid.cell_size) * np.asarray(grid.res)
    return lo, hi


@pytest.mark.parametrize("preset", ["cornell", "stress", "mesh"])
def test_every_prim_is_binned(preset):
    scene = presets.get_scene(preset)
    grid = build_grid(scene)
    S, T = scene.num_spheres, scene.num_triangles
    if S:
        sph_ids = np.unique(np.asarray(grid.sph_list))
        assert set(range(S)) <= set(sph_ids.tolist())
    if T:
        tri_ids = np.unique(np.asarray(grid.tri_list))
        assert set(range(T)) <= set(tri_ids.tolist())
    # counts consistent with -1 padding
    assert np.all((np.asarray(grid.sph_list) >= 0).sum(1)
                  == np.asarray(grid.sph_count))
    assert np.all((np.asarray(grid.tri_list) >= 0).sum(1)
                  == np.asarray(grid.tri_count))
    assert max_steps(grid) == sum(grid.res) + 1


@pytest.mark.parametrize("preset", ["cornell", "stress", "mesh"])
@pytest.mark.parametrize("differentiable", [True, False])
def test_nearest_hit_parity(preset, differentiable):
    scene = presets.get_scene(preset)
    grid = build_grid(scene)
    ro, rd = _random_rays(*_scene_bounds(grid), 4096, seed=1)
    ref = intersect.nearest_hit(ro, rd, scene)
    got = nearest_hit_grid(ro, rd, scene, grid,
                           differentiable=differentiable)
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(got.hit))
    np.testing.assert_array_equal(np.asarray(ref.prim), np.asarray(got.prim))
    # t to float tolerance: the grid path gathers sphere params per
    # candidate while the linear sweep broadcasts, so XLA's fusion order
    # (FMA contraction) differs by last-ulp on some platforms
    np.testing.assert_allclose(np.asarray(ref.t)[np.asarray(ref.hit)],
                               np.asarray(got.t)[np.asarray(ref.hit)],
                               rtol=2e-6, atol=0)


@pytest.mark.parametrize("preset", ["cornell", "stress"])
@pytest.mark.parametrize("differentiable", [True, False])
def test_any_hit_parity(preset, differentiable):
    scene = presets.get_scene(preset)
    grid = build_grid(scene)
    ro, rd = _random_rays(*_scene_bounds(grid), 4096, seed=2)
    for max_d in (0.5, 3.0, 50.0):
        ref = intersect.any_hit(ro, rd, max_d, scene)
        got = any_hit_grid(ro, rd, max_d, scene, grid,
                           differentiable=differentiable)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


@pytest.mark.slow
def test_jnp_render_identical_with_grid():
    """Full 16x16 cornell render: the grid must be invisible in the output.
    (Hits and occlusion are bit-identical — test above — so the image can
    differ only by XLA reassociation of identical selects; require exact.)"""
    scene = presets.cornell()
    cp = integrator.camera_arrays(Camera())
    grid = build_grid(scene)
    base = np.asarray(integrator.render(scene, cp, 16, 16, spp=2, seed=3,
                                        max_bounces=4, live_cutoff=None))
    fast = np.asarray(integrator.render(scene, cp, 16, 16, spp=2, seed=3,
                                        max_bounces=4, live_cutoff=None,
                                        grid=grid))
    np.testing.assert_allclose(base, fast, rtol=0, atol=1e-6)


@pytest.mark.slow
def test_gradients_flow_through_grid():
    """Material gradients through the DDA scan path equal the linear-sweep
    gradients (the gathers are differentiable; cell lists are constants)."""
    from cuda_path_tracer_ss.render import inverse
    scene = presets.cornell_lambert()
    cp = integrator.camera_arrays(Camera())
    grid = build_grid(scene)

    def loss(diffuse, g):
        s = inverse.with_field(scene, "materials.diffuse", diffuse)
        img = integrator.render(s, cp, 12, 12, spp=1, seed=5, max_bounces=3,
                                live_cutoff=None, grid=g)
        return jnp.mean(img ** 2)

    dx = inverse.get_field(scene, "materials.diffuse")
    g_base = np.asarray(jax.grad(loss)(dx, None))
    g_grid = np.asarray(jax.grad(loss)(dx, grid))
    assert np.any(g_base != 0.0)
    np.testing.assert_allclose(g_base, g_grid, rtol=1e-5, atol=1e-8)
