"""Gradient correctness — SURVEY §4 item 4 / BASELINE north star: jax.grad of
a pixel loss vs central finite differences on the same random streams, plus a
small end-to-end inverse-rendering recovery."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render import integrator, inverse

W = H = 24
SPP = 2
BOUNCES = 4


def _loss_for(scene, fields, spp=SPP, bounces=BOUNCES):
    cp = integrator.camera_arrays(Camera())
    target = jnp.zeros((H, W, 3), jnp.float32)  # MSE against black = mean image^2
    loss = inverse.make_loss(scene, cp, target, W, H, spp, max_bounces=bounces)
    params = inverse.extract_params(scene, fields)
    return loss, params


def _check(scene, fields, rtol, eps=2e-3, seed=0):
    loss, params = _loss_for(scene, fields)
    ad, fd = inverse.directional_fd_check(loss, params, seed, eps=eps)
    assert np.all(np.isfinite(ad)) and np.all(np.isfinite(fd))
    scale = np.maximum(np.abs(fd), np.abs(ad)).max() + 1e-8
    np.testing.assert_allclose(ad, fd, rtol=rtol, atol=0.02 * scale)


def test_grad_diffuse_albedo_matches_fd():
    _check(presets.cornell_lambert(), ["materials.diffuse"], rtol=0.05)


@pytest.mark.slow
def test_grad_emission_and_power_matches_fd():
    _check(presets.cornell_lambert(), ["materials.emission", "al_power"], rtol=0.05)


@pytest.mark.slow
def test_grad_specular_and_roughness_matches_fd():
    _check(presets.cornell(), ["materials.specular", "materials.roughness"],
           rtol=0.08)


def test_grad_absorption_matches_fd():
    _check(presets.glass_showcase(), ["materials.absorption"], rtol=0.08)


@pytest.mark.slow
def test_grad_sphere_geometry_interior_matches_fd():
    # Geometry gradients are interior-only (no silhouette boundary term —
    # SURVEY §7 hard part (b)). On a random scene FD is dominated by
    # visibility discontinuities, so the honest check is a silhouette-free
    # probe: a central crop whose rays all hit one big sphere interiorly,
    # lit by an unoccluded point light — there the full gradient IS the
    # interior term and AD must match FD tightly.
    from cuda_path_tracer_ss.models.scene import (MaterialSpec,
                                                      SceneBuilder)

    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(0.6, 0.5, 0.4), diff_avg=0.7))
    b.add_sphere((0.0, 0.0, -4.0), 2.0, m)
    b.add_point_light((0.0, 8.0, -4.0), (400.0, 400.0, 400.0))
    b.background = np.array([0.1, 0.1, 0.1], np.float32)
    scene = b.build()
    cp = integrator.camera_arrays(Camera())

    def loss(params, seed):
        s = inverse.merge_params(scene, params)
        img = integrator.render(s, cp, 16, 16, 4, seed, max_bounces=3,
                                live_cutoff=None)
        return jnp.mean(img[5:11, 5:11] ** 2)

    params = inverse.extract_params(scene, ["sph_center", "sph_radius"])
    ad, fd = inverse.directional_fd_check(loss, params, 1, eps=1e-3,
                                          num_directions=4)
    assert np.all(np.isfinite(ad)) and np.all(np.isfinite(fd))
    assert np.abs(ad).max() > 1e-6  # gradient actually flows
    np.testing.assert_allclose(ad, fd, rtol=0.02,
                               atol=0.02 * np.abs(fd).max())

    # on a full scene with silhouettes FD disagrees, but AD must stay finite
    loss2, params2 = _loss_for(presets.cornell(),
                               ["sph_center", "sph_radius"])
    g = jax.grad(loss2)(params2, 1)
    for name, arr in g.items():
        assert np.all(np.isfinite(np.asarray(arr))), name


@pytest.mark.slow
def test_grad_physical_mode_matches_fd():
    """Gradients through the unbiased estimator: the MIS machinery (power
    heuristic weights, per-lobe densities, prev_pdf carry) is full of
    where/clamp guards — FD-allclose on a scene that exercises all three
    light-sampled lobes (diffuse + Phong glossy + rough Cook-Torrance)
    proves none of them leaks a NaN or a wrong branch gradient."""
    from cuda_path_tracer_ss.models.presets import add_cornell_box
    from cuda_path_tracer_ss.models.scene import (MaterialSpec,
                                                      SceneBuilder)
    b = SceneBuilder()
    mg = b.add_material(MaterialSpec(
        diffuse=(0.2, 0.2, 0.5), diff_avg=0.3,
        specular=(0.9, 0.8, 0.6), spec_exp=40.0, spec_avg=0.5, ior=2.8))
    b.add_sphere((-1.6, -2.2, -5.0), 1.4, mg)
    mc = b.add_material(MaterialSpec(
        diffuse=(0.3, 0.2, 0.1), diff_avg=0.25,
        specular=(0.8, 0.7, 0.5), spec_avg=0.6, roughness=0.5, flags=3))
    b.add_sphere((1.6, -2.2, -5.0), 1.4, mc)
    add_cornell_box(b, 8.0)
    scene = b.build()

    cp = integrator.camera_arrays(Camera())
    target = jnp.zeros((H, W, 3), jnp.float32)
    loss = inverse.make_loss(scene, cp, target, W, H, SPP,
                             max_bounces=BOUNCES, physical=True)
    params = inverse.extract_params(
        scene, ["materials.diffuse", "materials.specular",
                "materials.roughness", "materials.emission"])
    ad, fd = inverse.directional_fd_check(loss, params, 3, eps=2e-3)
    assert np.all(np.isfinite(ad)) and np.all(np.isfinite(fd))
    assert np.abs(ad).max() > 1e-8
    scale = np.maximum(np.abs(fd), np.abs(ad)).max() + 1e-8
    np.testing.assert_allclose(ad, fd, rtol=0.08, atol=0.02 * scale)

    # the fused kernel renders forward only: asking it for a loss to
    # differentiate must fail loudly, never train on a silent zero
    with pytest.raises(ValueError, match="no gradient"):
        inverse.make_loss(scene, cp, target, W, H, SPP, engine="pallas",
                          physical=True)


@pytest.mark.slow
def test_grad_triangle_vertices_interior_matches_fd():
    # Triangle-vertex gradients, same interior-only stance as the sphere
    # probe: a big two-triangle quad fills the view, the central crop's rays
    # hit it far from any edge, lit by an unoccluded point light — the full
    # gradient there is the interior term (hit point, barycentric shading
    # normal, NEE geometry all differentiable through Moller-Trumbore), so
    # AD must match FD tightly. Per-corner shading normals (tri_n*) get the
    # same check — they feed the surfel normal via barycentric interp.
    from cuda_path_tracer_ss.models.scene import (MaterialSpec,
                                                      SceneBuilder)

    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(0.6, 0.5, 0.4), diff_avg=0.7))
    # quad in the z=-4 plane spanning well past the 16x16 frustum; slightly
    # tilted corner normals so the normal-interp path carries signal too
    v = [(-9.0, -9.0, -4.2), (9.0, -9.0, -3.8), (9.0, 9.0, -4.2),
         (-9.0, 9.0, -3.8)]
    n = [(0.1, 0.0, 1.0), (0.0, 0.1, 1.0), (-0.1, 0.0, 1.0),
         (0.0, -0.1, 1.0)]
    b.add_triangle(v[0], v[1], v[2], n[0], n[1], n[2], m)
    b.add_triangle(v[0], v[2], v[3], n[0], n[2], n[3], m)
    b.add_point_light((0.0, 6.0, -1.0), (400.0, 400.0, 400.0))
    b.background = np.array([0.1, 0.1, 0.1], np.float32)
    scene = b.build()
    cp = integrator.camera_arrays(Camera())

    def loss(params, seed):
        s = inverse.merge_params(scene, params)
        img = integrator.render(s, cp, 16, 16, 4, seed, max_bounces=2,
                                live_cutoff=None)
        return jnp.mean(img[5:11, 5:11] ** 2)

    params = inverse.extract_params(
        scene, ["tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2"])
    ad, fd = inverse.directional_fd_check(loss, params, 2, eps=1e-3,
                                          num_directions=4)
    assert np.all(np.isfinite(ad)) and np.all(np.isfinite(fd))
    assert np.abs(ad).max() > 1e-6  # gradient actually flows
    np.testing.assert_allclose(ad, fd, rtol=0.02,
                               atol=0.02 * np.abs(fd).max())

    # full scene with silhouettes: FD disagrees by nature, AD stays finite
    loss2, params2 = _loss_for(presets.cornell(), ["tri_v0", "tri_v1",
                                                   "tri_v2"])
    g = jax.grad(loss2)(params2, 1)
    for name, arr in g.items():
        assert np.all(np.isfinite(np.asarray(arr))), name


@pytest.mark.slow
def test_grad_camera_params_finite():
    scene = presets.cornell_lambert()
    cp = integrator.camera_arrays(Camera())
    target = jnp.zeros((H, W, 3), jnp.float32)

    def loss(cam):
        img = integrator.render(scene, cam, W, H, 1, 2,
                                max_bounces=3, live_cutoff=None)
        return jnp.mean((img - target) ** 2)

    g = jax.grad(loss)(cp)
    flat = np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(g)])
    assert np.all(np.isfinite(flat))
    assert np.abs(flat).max() > 0  # gradient actually flows to the camera


@pytest.mark.slow
def test_no_nan_grads_on_showcase():
    # The full quirk soup: CT flags, pure mirrors, glass, two area lights.
    loss, params = _loss_for(presets.showcase(),
                             ["materials.diffuse", "materials.emission",
                              "materials.roughness", "materials.absorption",
                              "al_power"], spp=1, bounces=6)
    g = jax.grad(loss)(params, 3)
    for name, arr in g.items():
        assert np.all(np.isfinite(np.asarray(arr))), f"NaN/Inf grad in {name}"


@pytest.mark.slow
def test_inverse_rendering_recovers_albedo():
    # BASELINE config 4 (shrunk): perturb the two sphere albedos, recover by
    # pixel-gradient descent against a fixed-seed target render.
    scene_true = presets.cornell_lambert()
    cp = integrator.camera_arrays(Camera())
    key = 7
    target = integrator.render(scene_true, cp, W, H, 4, key,
                               max_bounces=3, live_cutoff=None)

    diffuse_true = inverse.get_field(scene_true, "materials.diffuse")
    perturbed = jnp.clip(diffuse_true + 0.35, 0.05, 1.0)
    scene0 = inverse.with_field(scene_true, "materials.diffuse", perturbed)

    recovered, params, losses = inverse.invert(
        scene0, cp, target, ["materials.diffuse"], W, H, spp=4, steps=120,
        lr=0.05, max_bounces=3, seed=7)
    assert losses[-1] < 1e-4, losses[::20]
    got = np.asarray(params["materials.diffuse"])
    want = np.asarray(diffuse_true)
    # Every material that appears in the image converges to the truth; the
    # light material (diff_avg=0, never shaded) is invisible to the loss and
    # stays at its perturbed value, so compare via median over materials.
    err = np.abs(got - want).max(axis=-1)
    assert np.median(err) < 0.05, (got, want)


@pytest.mark.slow
def test_invert_with_resampling_converges():
    # stochastic-gradient mode: a fresh RNG stream every k steps still
    # descends toward the truth (noisier loss, so the bar is coarser)
    scene_true = presets.cornell_lambert()
    cp = integrator.camera_arrays(Camera())
    key = 3
    target = integrator.render(scene_true, cp, 16, 16, 4, key,
                               max_bounces=3, live_cutoff=None)
    truth = inverse.get_field(scene_true, "materials.diffuse")
    scene0 = inverse.with_field(scene_true, "materials.diffuse",
                                jnp.clip(truth + 0.3, 0.05, 1.0))
    _, params, losses = inverse.invert(
        scene0, cp, target, ["materials.diffuse"], 16, 16, spp=4, steps=100,
        lr=0.05, seed=3, max_bounces=3, resample_every=10)
    # median over materials: the emissive light material is invisible to the
    # loss (diff_avg=0) and never converges, as in the deterministic test.
    # Stochastic mode fights target-vs-render stream mismatch noise, so this
    # is a descent smoke test, not a convergence bound (the deterministic
    # test above covers full recovery).
    err0 = np.median(np.abs(np.asarray(jnp.clip(truth + 0.3, 0.05, 1.0))
                            - np.asarray(truth)).max(-1))
    err1 = np.median(np.abs(np.asarray(params["materials.diffuse"])
                            - np.asarray(truth)).max(-1))
    assert err1 < err0 * 0.75, (err0, err1)
