"""Estimator correctness: the JAX masked-wavefront integrator against the
independent scalar numpy oracle (tests/reference_tracer.py), fed identical
threefry streams — plus black-box invariants."""
import jax
import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.models.scene import MaterialSpec, SceneBuilder, translate, scale
from cuda_path_tracer_ss.render import integrator
from cuda_path_tracer_ss.utils import rng

from reference_tracer import SceneView, trace_one

W = H = 12
BOUNCES = 4


def _run_both(scene, max_bounces=BOUNCES, width=W, height=H, seed=0):
    cam = Camera()
    cp = integrator.camera_arrays(cam)
    n = width * height
    pixel_idx = jnp.arange(n, dtype=jnp.int32)
    sample = jnp.int32(0)

    jx, jy = rng.eye_jitter(seed, pixel_idx, sample)
    o, d = integrator.eye_rays_for_indices(cp, width, height, pixel_idx,
                                           jx, jy)
    got = integrator.trace(scene, o, d, seed, sample, pixel_idx,
                           max_bounces=max_bounces).to_array()
    got = np.asarray(got)

    # identical uniform blocks for the oracle
    blocks = [
        np.asarray(rng.bounce_rows(seed, pixel_idx, sample, b,
                                   scene.num_area_lights))
        for b in range(max_bounces)
    ]
    sv = SceneView(scene)
    origins = np.stack([np.asarray(o.x), np.asarray(o.y), np.asarray(o.z)], -1)
    dirs = np.stack([np.asarray(d.x), np.asarray(d.y), np.asarray(d.z)], -1)
    want = np.stack([
        trace_one(sv, origins[i].astype(np.float64), dirs[i].astype(np.float64),
                  blocks, max_bounces, i)
        for i in range(n)
    ])
    return got, want


def _assert_mostly_close(got, want, frac=0.97, atol=2e-3, rtol=2e-3):
    close = np.isclose(got, want, atol=atol, rtol=rtol).all(axis=-1)
    assert close.mean() >= frac, (
        f"only {close.mean():.3f} of rays match; worst diff "
        f"{np.abs(got - want).max():.4f}")
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=0.02, atol=5e-3)


def test_cornell_matches_scalar_oracle():
    got, want = _run_both(presets.cornell())
    _assert_mostly_close(got, want)


def test_showcase_matches_scalar_oracle():
    got, want = _run_both(presets.showcase())
    _assert_mostly_close(got, want, frac=0.95)


def test_point_light_scene_matches_oracle():
    got, want = _run_both(presets.point_light_spheres())
    _assert_mostly_close(got, want)


def test_empty_scene_returns_background():
    b = SceneBuilder()
    b.background = np.array([0.25, 0.5, 0.75], np.float32)
    scene = b.build()
    cam = Camera()
    cp = integrator.camera_arrays(cam)
    img = integrator.render(scene, cp, 8, 8, 2, 1,
                            max_bounces=3, live_cutoff=None)
    np.testing.assert_allclose(np.asarray(img),
                               np.broadcast_to([0.25, 0.5, 0.75], (8, 8, 3)),
                               rtol=1e-6)


def test_emissive_wall_radiance():
    # A large emissive rect right in front of the camera: first-bounce
    # emission contributes exactly the emittance (throughput 1).
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(emission=(0.3, 0.6, 0.9)))
    b.add_rect(translate((0, 0, -2)) @ scale((50, 50, 1)), m)
    scene = b.build()
    cp = integrator.camera_arrays(Camera())
    img = np.asarray(integrator.render(scene, cp, 8, 8, 1,
                                       2, max_bounces=2,
                                       live_cutoff=None))
    np.testing.assert_allclose(img, np.broadcast_to([0.3, 0.6, 0.9], (8, 8, 3)),
                               rtol=1e-5, atol=1e-6)


def test_determinism_same_key():
    scene = presets.cornell()
    cp = integrator.camera_arrays(Camera())
    img1 = np.asarray(integrator.render(scene, cp, 8, 8, 2, 3,
                                        max_bounces=3))
    img2 = np.asarray(integrator.render(scene, cp, 8, 8, 2, 3,
                                        max_bounces=3))
    np.testing.assert_array_equal(img1, img2)


def test_while_loop_matches_scan_at_high_cutoff():
    # With a cutoff of 0 live rays the while_loop runs all bounces, minus the
    # final no-scatter trick — radiance must agree exactly with the scan path.
    scene = presets.cornell()
    cp = integrator.camera_arrays(Camera())
    k = 4
    a = np.asarray(integrator.render(scene, cp, 8, 8, 2, k, max_bounces=4,
                                     live_cutoff=None))
    b = np.asarray(integrator.render(scene, cp, 8, 8, 2, k, max_bounces=4,
                                     live_cutoff=0))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_no_nans_on_showcase():
    scene = presets.showcase()
    cp = integrator.camera_arrays(Camera())
    img = np.asarray(integrator.render(scene, cp, 16, 16, 2,
                                       5, max_bounces=8))
    assert np.all(np.isfinite(img))
