"""Tests for aux subsystems: compaction, debug NaN guards, profiling meter,
image IO round-trips, per-ray RNG invariance."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.ops.compaction import live_count, partition_by_activity
from cuda_path_tracer_ss.render.integrator import (
    camera_arrays, eye_rays_for_indices, initial_state, bounce,
    uniforms_per_bounce)
from cuda_path_tracer_ss.utils import debug, image as image_io, profiling, rng


def _state_after_one_bounce(scene, n=64):
    cp = camera_arrays(Camera())
    idx = jnp.arange(n, dtype=jnp.int32)
    jx, jy = rng.eye_jitter(0, idx, 0)
    o, d = eye_rays_for_indices(cp, 8, 8, idx, jx, jy)
    st = initial_state(o, d)
    u = rng.bounce_rows(0, idx, 0, 0, scene.num_area_lights)
    return bounce(scene, st, u)


@pytest.mark.slow
def test_partition_moves_live_to_prefix():
    scene = presets.cornell_empty()
    st = _state_after_one_bounce(scene)
    st2, n_live = partition_by_activity(st)
    n_live = int(n_live)
    act = np.asarray(st2.active)
    assert act[:n_live].all()
    assert not act[n_live:].any()
    # same multiset of radiance values
    np.testing.assert_allclose(sorted(np.asarray(st.radiance.x)),
                               sorted(np.asarray(st2.radiance.x)))
    assert int(live_count(st)) == n_live


@pytest.mark.slow
def test_checked_render_clean_scene_passes():
    img = debug.checked_render(presets.cornell_empty(),
                               camera_arrays(Camera()), 8, 8, 1,
                               0, max_bounces=2)
    assert np.all(np.isfinite(np.asarray(img)))


def test_assert_finite_raises():
    with pytest.raises(FloatingPointError, match="bad"):
        debug.assert_finite({"x": jnp.asarray([1.0, np.nan])}, name="bad")
    debug.assert_finite({"x": jnp.asarray([1.0, 2.0])})  # no raise


def test_pass_meter(tmp_path):
    path = str(tmp_path / "passes.jsonl")
    m = profiling.PassMeter(64, 64, jsonl_path=path)
    rec = m.record(4, 0.5)
    assert rec["samples_per_pixel"] == 4
    assert rec["primary_rays_per_s"] == 64 * 64 * 4 / 0.5
    assert "Rays per pixel: 4" in m.console_line(rec)
    m.record(4, 0.5)
    assert len(open(path).readlines()) == 2


def test_png_round_trip(tmp_path):
    rng_np = np.random.default_rng(0)
    img = rng_np.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    image_io.write_png(p, img, bottom_up=False)
    back = image_io.read_png(p)
    np.testing.assert_array_equal(back, img)


def test_bounce_rows_layout_invariance():
    # The stream for pixel p must not depend on which block/tile asks for it.
    full = rng.bounce_rows(5, jnp.arange(64, dtype=jnp.int32), 2, 1, 2)
    part = rng.bounce_rows(5, jnp.asarray([3, 17, 42], jnp.int32), 2, 1, 2)
    np.testing.assert_array_equal(np.asarray(full[:, [3, 17, 42]]),
                                  np.asarray(part))


def test_threefry_matches_jax_reference():
    # At rounds=20 our int32 Threefry-2x32 is bitwise the canonical one
    # (jax's own) — validates the generator's round structure. The renderer
    # runs rng.ROUNDS (13, the BigCrush-passing minimum) for speed.
    from jax._src.prng import threefry_2x32
    r = np.random.RandomState(0)
    k = r.randint(-2**31, 2**31, size=(2, 32)).astype(np.int32)
    x = r.randint(-2**31, 2**31, size=(2, 32)).astype(np.int32)
    want = threefry_2x32(jnp.asarray(k).astype(jnp.uint32),
                         jnp.asarray(x).astype(jnp.uint32))
    got0, got1 = rng.threefry2x32(k[0], k[1], x[0], x[1], rounds=20)
    got = jnp.concatenate([got0, got1]).astype(jnp.uint32)
    np.testing.assert_array_equal(np.asarray(want).reshape(-1),
                                  np.asarray(got).reshape(-1))


def test_uniform_pair_range_and_determinism():
    idx = jnp.arange(4096, dtype=jnp.int32)
    a0, a1 = rng.uniform_pair(9, idx, 3, 7)
    b0, _ = rng.uniform_pair(9, idx, 3, 7)
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(b0))
    for u in (np.asarray(a0), np.asarray(a1)):
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.02


def test_live_ray_stats_monotone():
    from cuda_path_tracer_ss.render.integrator import live_ray_stats
    scene = presets.cornell()
    cp = camera_arrays(Camera())
    fracs = np.asarray(live_ray_stats(scene, cp, 16, 16,
                                      0, max_bounces=6))
    assert fracs[0] == 1.0                      # all rays live at bounce 0
    assert np.all(np.diff(fracs) <= 1e-6)       # monotonically draining
    assert fracs[-1] < 1.0


def test_packed_scene_layout_contract():
    # Guards the kernel<->pack_scene column contract (an out-of-bounds
    # table read from a drifted material column count survived until
    # review).
    from cuda_path_tracer_ss.ops.pallas.megakernel import pack_scene

    scene = presets.showcase()
    p = pack_scene(scene)
    assert p.spheres.shape == (scene.num_spheres, 5)
    assert p.triangles.shape == (scene.num_triangles, 19)
    assert p.materials.shape == (scene.materials.flags.shape[0], 20)
    # 18 verts + 3 power + owning-tri index + light material index
    # (cols 21-22 feed the physical estimator's emission-MIS lookups)
    assert p.area_lights.shape == (scene.num_area_lights, 23)
    assert p.point_lights.shape[1] == 6
    assert p.background.shape == (3,)
    assert p.counts == (scene.num_spheres, scene.num_triangles,
                        scene.materials.flags.shape[0],
                        scene.num_point_lights, scene.num_area_lights)
    # triangle cols 3..8 are edges relative to v0
    import numpy as np
    tris = np.asarray(p.triangles)
    v0 = np.stack([np.asarray(scene.tri_v0.x), np.asarray(scene.tri_v0.y),
                   np.asarray(scene.tri_v0.z)], -1)
    v1 = np.stack([np.asarray(scene.tri_v1.x), np.asarray(scene.tri_v1.y),
                   np.asarray(scene.tri_v1.z)], -1)
    np.testing.assert_allclose(tris[:, 3:6], v1 - v0, atol=1e-6)


def test_packed_scene_empty_bundles_padded():
    from cuda_path_tracer_ss.models.scene import SceneBuilder, MaterialSpec
    from cuda_path_tracer_ss.ops.pallas.megakernel import pack_scene

    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(1, 1, 1), diff_avg=0.5))
    b.add_sphere((0, 0, -3), 1.0, m)
    p = pack_scene(b.build())  # no triangles, no lights
    assert p.triangles.shape[0] == 1      # padded dummy row
    assert p.point_lights.shape[0] == 1
    assert p.area_lights.shape[0] == 1
    assert p.counts[1] == 0 and p.counts[3] == 0 and p.counts[4] == 0


def test_persistent_compile_cache_config(tmp_path, monkeypatch):
    import jax
    from cuda_path_tracer_ss.utils.compile_cache import (
        enable_persistent_cache)

    prev = jax.config.jax_compilation_cache_dir
    try:
        # conftest gates the cache off for CPU sessions; this test checks
        # the enable path itself, so lift the gate locally
        monkeypatch.delenv("CPT_NO_COMPILE_CACHE", raising=False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = tmp_path / "xla_cache"
        got = enable_persistent_cache(str(d))
        assert got == str(d) and d.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(d)

        monkeypatch.setenv("CPT_NO_COMPILE_CACHE", "1")
        assert enable_persistent_cache(str(d)) is None
    finally:
        # restore the process-global cache dir — later tests in this
        # session must not silently compile into the pytest tmp dir
        jax.config.update("jax_compilation_cache_dir", prev)
