"""Bidirectional estimator (render/bidir.py): the MIS-weighted combination
of forward path tracing and light tracing must (a) converge to the same
image as the forward physical estimator, (b) keep camera-visible specular
surfaces that pure light tracing renders black, (c) estimate the caustic
with lower variance than forward-only sampling — the three "done" criteria
of VERDICT r3 ask #1."""
import numpy as np
import pytest

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render.bidir import render_bidir
from cuda_path_tracer_ss.render.integrator import camera_arrays, render
from cuda_path_tracer_ss.render.lighttrace import render_lighttrace


def test_nu_zero_limit_is_the_physical_estimator():
    """As n_paths/spp -> 0 the light-trace techniques carry no weight and
    the forward half of the bidirectional estimator must reproduce the
    plain physical estimator exactly (every rho/r_lt term vanishes)."""
    scene = presets.cornell_lambert()
    cp = camera_arrays(Camera())
    plain = np.asarray(render(scene, cp, 16, 16, 8, 0, max_bounces=4,
                              live_cutoff=None, physical=True))
    tiny = np.asarray(render(scene, cp, 16, 16, 8, 0, max_bounces=4,
                             live_cutoff=None, physical=True,
                             bidir_nu=1e-12))
    np.testing.assert_allclose(tiny, plain, rtol=0, atol=1e-6)


@pytest.mark.slow  # 17 s statistical agreement; the exact nu->0 limit
# test keeps bidir correctness in the fast gate
def test_bidir_agrees_with_forward_physical():
    """Estimator agreement (done-criterion c, first half): the combined
    image converges to the forward physical estimator on a scene both
    families cover. Measured at these counts during bring-up: channel
    means within 0.4%, 4x4-block median rel err ~1%."""
    scene = presets.cornell_lambert()
    cp = camera_arrays(Camera())
    W = H = 16
    ref = np.asarray(render(scene, cp, W, H, 256, 0, max_bounces=5,
                            live_cutoff=None, physical=True)).astype(float)
    comb = np.asarray(render_bidir(scene, cp, W, H, 64, 40_000, 0,
                                   max_bounces=5)).astype(float)
    np.testing.assert_allclose(comb.mean((0, 1)), ref.mean((0, 1)),
                               rtol=0.03)
    rb = ref.reshape(4, 4, 4, 4, 3).mean((1, 3))
    cb = comb.reshape(4, 4, 4, 4, 3).mean((1, 3))
    rel = np.abs(rb - cb) / np.maximum(rb, 1e-3)
    assert np.median(rel) < 0.05, np.median(rel)
    assert rel.max() < 0.25, rel.max()


@pytest.mark.slow
def test_caustic_glass_visible_and_caustic_converged():
    """The shipped-artifact fix (done-criteria a+b): on the caustic preset
    the light tracer renders the glass sphere BLACK (no eye-side subpath);
    the combined estimator must render it at the forward estimator's
    brightness while the floor caustic matches the light-trace-only
    estimate (the family where light paths are sharp)."""
    scene = presets.caustic()
    cp = camera_arrays(Camera())
    W = H = 32
    lt = np.asarray(render_lighttrace(scene, cp, W, H, 300_000, 0,
                                      max_bounces=6))
    fwd = np.asarray(render(scene, cp, W, H, 192, 0, max_bounces=6,
                            live_cutoff=None, physical=True))
    bi = np.asarray(render_bidir(scene, cp, W, H, 96, 200_000, 0,
                                 max_bounces=6))
    # the glass sphere (camera-visible specular): rows 4-7, cols 20-26
    sph = (slice(4, 8), slice(20, 27))
    assert lt[sph].mean() < 1e-3, "light tracing should miss the sphere"
    assert fwd[sph].mean() > 5e-3
    np.testing.assert_allclose(bi[sph].mean(), fwd[sph].mean(), rtol=0.25)
    # the caustic arc on the floor: rows 0-2, cols 21-28 — its PEAK is
    # many times the ambient left floor, and the region agrees between
    # bidir and the converged LT image (LT-family paths dominate there)
    ca = (slice(0, 3), slice(21, 29))
    ambient = lt[0:3, 3:10].mean()
    assert lt[ca].max() > 4 * ambient, (lt[ca].max(), ambient)
    assert lt[ca].mean() > 2 * ambient, (lt[ca].mean(), ambient)
    np.testing.assert_allclose(bi[ca].mean(), lt[ca].mean(), rtol=0.2)


@pytest.mark.slow
def test_caustic_inversion_bidir_beats_forward():
    """Round 5 (VERDICT r4 ask #2, the demo that justifies bidir
    training): recover the emitter's emission from a caustic-dominated
    target on presets.shadowed_caustic — the floor sees the light ONLY
    through the glass ball. At MATCHED per-step budget (fwd 8 spp vs
    bidir 4 spp + 4*W*H light paths = 4608 path starts each, 250 Adam
    steps, resampled streams):

    * forward-only physical gradients are variance-dominated: the rare
      double-refraction chains produce spiky overestimates whose MSE
      gradient pushes emission toward ZERO (measured: rel err 0.65 ->
      ~0.99, i.e. collapse);
    * the bidir estimator's light half sees the caustic every step:
      emission converges (rel err 0.65 -> ~0.18 and still descending).

    Asserted at robust margins: bidir < 0.35, fwd > 0.6, bidir < 0.5*fwd.
    """
    from cuda_path_tracer_ss.render import inverse

    scene = presets.shadowed_caustic()
    cp = camera_arrays(Camera())
    W = H = 24
    target = render_bidir(scene, cp, W, H, 64, 600_000, 123, max_bounces=6)
    fields = ["materials.emission"]
    em_true = np.asarray(
        inverse.extract_params(scene, fields)["materials.emission"])
    import jax.numpy as jnp
    li = int(np.abs(em_true).sum(1).argmax())   # the light's material row
    start = inverse.with_field(scene, "materials.emission",
                               jnp.asarray(em_true * 0.35))

    _, pb, _ = inverse.invert(start, cp, target, fields, W, H, spp=4,
                              steps=250, lr=0.5, max_bounces=6, seed=0,
                              resample_every=1, engine="bidir",
                              physical=True)
    _, pf, _ = inverse.invert(start, cp, target, fields, W, H, spp=8,
                              steps=250, lr=0.5, max_bounces=6, seed=0,
                              resample_every=1, engine="jnp",
                              physical=True)
    eb = np.abs(np.asarray(pb["materials.emission"])[li]
                - em_true[li]) / em_true[li]
    ef = np.abs(np.asarray(pf["materials.emission"])[li]
                - em_true[li]) / em_true[li]
    assert eb.max() < 0.35, (eb, ef)
    assert ef.min() > 0.6, (eb, ef)
    assert eb.max() < 0.5 * ef.min(), (eb, ef)


@pytest.mark.slow
def test_caustic_variance_reduction_quantified():
    """Done-criterion c, second half: on the caustic region the combined
    estimator beats forward-only sampling at MATCHED budget (32 spp +
    32768 light paths vs 64 spp over a 32x32 image = 65536 path starts
    each). The metric is per-pixel MSE against a converged bidir
    reference — it captures the forward estimator's blotch noise that a
    region-mean hides. Measured during bring-up: 7.8x reduction
    (fwd MSE 1.2e-3 vs bidir 1.6e-4); asserted at >=3x."""
    scene = presets.caustic()
    cp = camera_arrays(Camera())
    W = H = 32
    ca = (slice(0, 3), slice(21, 29))
    ref = np.asarray(render_bidir(scene, cp, W, H, 192, 1_000_000, 99,
                                  max_bounces=6))
    f_mse, b_mse = [], []
    for seed in range(3):
        f = np.asarray(render(scene, cp, W, H, 64, seed, max_bounces=6,
                              live_cutoff=None, physical=True))
        b = np.asarray(render_bidir(scene, cp, W, H, 32, 32_768, seed,
                                    max_bounces=6))
        f_mse.append(((f[ca] - ref[ca]) ** 2).mean())
        b_mse.append(((b[ca] - ref[ca]) ** 2).mean())
    ratio = np.mean(f_mse) / np.mean(b_mse)
    assert ratio > 3.0, (ratio, f_mse, b_mse)


def test_bidir_requires_area_light():
    from cuda_path_tracer_ss.models.scene import (MaterialSpec,
                                                      SceneBuilder)
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(0.5, 0.5, 0.5), diff_avg=0.5))
    b.add_sphere((0, 0, -4), 1.0, m)
    b.add_point_light((0, 3, -4), (10.0, 10.0, 10.0))
    cp = camera_arrays(Camera())
    with pytest.raises(ValueError, match="area light"):
        render_bidir(b.build(), cp, 8, 8, 4, 100, 0, max_bounces=2)


def test_bidir_loss_gating_and_fd_grads():
    """Round 5 (VERDICT r4 ask #2): make_loss(engine='bidir') trains
    through the combined MIS estimator. Gating: physical=True required,
    al_power rejected (the physical estimator emits materials.emission).
    Gradients: <grad, v> matches central differences on the SAME streams
    for emission + diffuse (throughput-linear through both halves —
    splat pixel indices are detached on both sides, so FD and AD see the
    same interior surface at this eps)."""
    import jax.numpy as jnp
    from cuda_path_tracer_ss.render import inverse

    scene = presets.cornell_lambert()
    cp = camera_arrays(Camera())
    with pytest.raises(ValueError, match="PHYSICAL"):
        inverse.make_loss(scene, cp, jnp.zeros((8, 8, 3)), 8, 8, 2,
                          max_bounces=3, engine="bidir")
    with pytest.raises(ValueError, match="al_power"):
        inverse.check_engine_fields("bidir", ["al_power"])
    inverse.check_engine_fields("bidir", ["pl_power", "materials.emission"])

    fields = ["materials.emission", "materials.diffuse"]
    W = H = 12
    target = jnp.zeros((H, W, 3), jnp.float32)
    loss = inverse.make_loss(scene, cp, target, W, H, 2, max_bounces=3,
                             engine="bidir", physical=True,
                             field_names=fields)
    params = inverse.extract_params(scene, fields)
    ad, fd = inverse.directional_fd_check(loss, params, seed=0, eps=2e-3)
    np.testing.assert_allclose(ad, fd, rtol=0.08, atol=5e-7)
    assert np.abs(ad).max() > 1e-7  # real gradients, not zeros


@pytest.mark.slow
def test_bidir_sharded_matches_single():
    """SPMD bidir: pixel-sharded forward half + path-sharded light half
    over the same 8 devices == the single-device combined image (forward
    half bitwise by per-pixel streams; light half to splat-reorder
    tolerance, as in test_lighttrace_sharded_matches_single)."""
    from cuda_path_tracer_ss.parallel import mesh as mesh_lib
    from cuda_path_tracer_ss.render.bidir import render_bidir_sharded

    scene = presets.cornell_lambert()
    cp = camera_arrays(Camera())
    W = H = 16
    single = np.asarray(render_bidir(scene, cp, W, H, 4, 2048, 0,
                                     max_bounces=3))
    out = np.asarray(render_bidir_sharded(
        scene, cp, W, H, 4, 2048, 0,
        mesh_lib.make_mesh(8), mesh_lib.make_mesh(8, axis=mesh_lib.PATH_AXIS),
        max_bounces=3))
    np.testing.assert_allclose(out, single, rtol=0, atol=5e-4)
    assert (np.abs(out - single) < 2e-5).mean() > 0.99


