"""The ``physical=True`` estimator mode — unbiased direct lighting.

A capability beyond the reference (which has only the quirky estimator:
point-light falloff for area lights, emitter double-count — SURVEY §3.4).
Three checks, strongest first:

1. The uniform-area light sampler is actually uniform (moment test).
2. ``shade_physical`` matches brute-force quadrature of the direct-lighting
   integral at a known unoccluded receiver (the measure/pdf math).
3. NEE-with-emission-suppression and pure BSDF sampling estimate the SAME
   image in expectation (the unbiasedness / no-double-count property the
   default estimator deliberately violates for reference parity).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.ops.shading import (area_light_sample_uniform,
                                                 shade_physical)
from cuda_path_tracer_ss.ops.vec import Vec3
from cuda_path_tracer_ss.render.integrator import camera_arrays, render


def _uniforms(key, n):
    return jax.random.uniform(key, (n,), jnp.float32)


def test_uniform_area_sampling_moments():
    """Sampled points on the cornell light average to the area-weighted
    centroid, and the per-axis spread matches a uniform rectangle."""
    scene = presets.cornell()
    n = 20000
    k = jax.random.PRNGKey(0)
    u1, u2, up = (_uniforms(jax.random.fold_in(k, i), n) for i in range(3))
    p, n_l, area, l_e = area_light_sample_uniform(scene, 0, u1, u2, up)

    tri0 = int(scene.al_tri0[0])
    verts = []
    for t in (tri0, tri0 + 1):
        verts += [[float(v.x[t]), float(v.y[t]), float(v.z[t])]
                  for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    verts = np.unique(np.round(np.asarray(verts), 5), axis=0)
    lo, hi = verts.min(0), verts.max(0)
    center = (lo + hi) / 2

    pts = np.stack([np.asarray(p.x), np.asarray(p.y), np.asarray(p.z)], -1)
    # inside the rectangle's AABB (flat light -> exact containment test)
    assert (pts >= lo - 1e-4).all() and (pts <= hi + 1e-4).all()
    np.testing.assert_allclose(pts.mean(0), center, atol=0.02 * (
        np.abs(hi - lo).max() + 1))
    # uniform on [lo, hi]: std = (hi-lo)/sqrt(12) on the two extended axes
    ext = hi - lo
    for ax in range(3):
        if ext[ax] > 1e-3:
            np.testing.assert_allclose(pts[:, ax].std(),
                                       ext[ax] / np.sqrt(12.0), rtol=0.05)


def test_shade_physical_matches_quadrature():
    """MC direct lighting at one unoccluded receiver == deterministic
    quadrature of integral L_e f_d cos_s cos_l / d^2 dA over the light."""
    scene = presets.cornell_empty()
    # receiver on the floor center, normal +Y (the box is empty, so the
    # shadow rays to the ceiling light are unoccluded)
    floor_y = float(jnp.min(scene.tri_v0.y))
    n = 60000
    point = Vec3(jnp.zeros((n,)), jnp.full((n,), floor_y + 0.5),
                 jnp.full((n,), -6.0))
    normal = Vec3(jnp.zeros((n,)), jnp.ones((n,)), jnp.zeros((n,)))
    diffuse = Vec3(jnp.full((n,), 0.7), jnp.full((n,), 0.5),
                   jnp.full((n,), 0.3))
    diff_avg = jnp.full((n,), 0.8)

    k = jax.random.PRNGKey(1)
    rows = jnp.stack([_uniforms(jax.random.fold_in(k, i), n)
                      for i in range(4 * scene.num_area_lights)])
    mc = shade_physical(scene, point, normal, diffuse, diff_avg, rows)
    mc_rgb = np.array([np.asarray(mc.x).mean(), np.asarray(mc.y).mean(),
                       np.asarray(mc.z).mean()])

    # quadrature over each light triangle with a barycentric grid
    px = np.array([0.0, floor_y + 0.5, -6.0])
    nrm = np.array([0.0, 1.0, 0.0])
    dif = np.array([0.7, 0.5, 0.3])
    total = np.zeros(3)
    for li in range(scene.num_area_lights):
        tri0 = int(scene.al_tri0[li])
        mat = int(scene.tri_mat[tri0])
        l_e = np.array([float(scene.materials.emission.x[mat]),
                        float(scene.materials.emission.y[mat]),
                        float(scene.materials.emission.z[mat])])
        for t in (tri0, tri0 + 1):
            v0 = np.array([float(scene.tri_v0.x[t]), float(scene.tri_v0.y[t]),
                           float(scene.tri_v0.z[t])])
            v1 = np.array([float(scene.tri_v1.x[t]), float(scene.tri_v1.y[t]),
                           float(scene.tri_v1.z[t])])
            v2 = np.array([float(scene.tri_v2.x[t]), float(scene.tri_v2.y[t]),
                           float(scene.tri_v2.z[t])])
            n_raw = np.cross(v1 - v0, v2 - v0)
            area = 0.5 * np.linalg.norm(n_raw)
            n_l = n_raw / np.linalg.norm(n_raw)
            g = 160
            acc = 0.0
            cnt = 0
            for i in range(g):
                for j in range(g - i):
                    w1 = (i + 1 / 3) / g
                    w2 = (j + 1 / 3) / g
                    lp = v0 * (1 - w1 - w2) + v1 * w1 + v2 * w2
                    off = lp - px
                    d2 = off @ off
                    w = off / np.sqrt(d2)
                    cs = max(0.0, nrm @ w)
                    cl = abs(n_l @ w)
                    acc += cs * cl / d2
                    cnt += 1
            total += l_e * dif * 0.8 / np.pi * acc * (area / cnt)
    np.testing.assert_allclose(mc_rgb, total, rtol=0.03)


@pytest.mark.slow
def test_physical_nee_and_bsdf_estimators_agree():
    """The whole point of the mode: light sampling (with emission
    suppression) and BSDF sampling estimate the same integral. The default
    reference-parity estimator fails this by design (emitter double-count,
    point-falloff area lights)."""
    scene = presets.cornell_lambert()
    cp = camera_arrays(Camera())
    W = H = 12

    img_nee = np.asarray(render(scene, cp, W, H, 192, 3, max_bounces=4,
                                live_cutoff=None, physical=True, nee=True))
    img_bsdf = np.asarray(render(scene, cp, W, H, 3072, 3, max_bounces=4,
                                 live_cutoff=None, physical=True, nee=False))
    m_nee = img_nee.mean()
    m_bsdf = img_bsdf.mean()
    assert abs(m_nee - m_bsdf) / m_nee < 0.05, (m_nee, m_bsdf)

    # and the default estimator is indeed a different (brighter) image:
    # emitter double-count + point-light falloff for the area light
    img_ref = np.asarray(render(scene, cp, W, H, 192, 3, max_bounces=4,
                                live_cutoff=None))
    assert abs(img_ref.mean() - m_nee) / m_nee > 0.05


def test_physical_mode_keeps_default_estimator_untouched():
    """physical=False path is bit-identical to before the flag existed —
    golden images guard this too, but assert directly at a tiny size."""
    scene = presets.cornell()
    cp = camera_arrays(Camera())
    a = np.asarray(render(scene, cp, 8, 8, 2, 9, max_bounces=3,
                          live_cutoff=None))
    b = np.asarray(render(scene, cp, 8, 8, 2, 9, max_bounces=3,
                          live_cutoff=None, physical=False, nee=True))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_physical_agreement_with_inside_diffuse_paths():
    """Regression (self-review finding): a diffuse scatter off an INSIDE
    hit gets no NEE, so it must not claim light-sampling coverage — its
    prev_pdf stays 0 and the next emission hit keeps full weight. A
    diffuse+refractive material makes such paths common; the NEE-MIS and
    pure-BSDF estimators must still agree in expectation."""
    import dataclasses
    scene = presets.cornell_lambert()
    mats = scene.materials
    # add a big translucent-diffuse sphere in front of the light
    from cuda_path_tracer_ss.models.scene import Materials
    from cuda_path_tracer_ss.ops.vec import Vec3 as V

    def _cat(v, extra):
        return V(jnp.concatenate([v.x, jnp.float32(jnp.asarray([extra[0]]))]),
                 jnp.concatenate([v.y, jnp.float32(jnp.asarray([extra[1]]))]),
                 jnp.concatenate([v.z, jnp.float32(jnp.asarray([extra[2]]))]))

    new_mats = Materials(
        diffuse=_cat(mats.diffuse, (0.6, 0.6, 0.6)),
        specular=_cat(mats.specular, (0.0, 0.0, 0.0)),
        absorption=_cat(mats.absorption, (0.05, 0.05, 0.05)),
        emission=_cat(mats.emission, (0.0, 0.0, 0.0)),
        spec_exp=jnp.concatenate([mats.spec_exp, jnp.asarray([jnp.inf])]),
        ior=jnp.concatenate([mats.ior, jnp.asarray([1.4], jnp.float32)]),
        diff_avg=jnp.concatenate([mats.diff_avg, jnp.asarray([0.35],
                                                             jnp.float32)]),
        spec_avg=jnp.concatenate([mats.spec_avg, jnp.asarray([0.0],
                                                             jnp.float32)]),
        refr_avg=jnp.concatenate([mats.refr_avg, jnp.asarray([0.6],
                                                             jnp.float32)]),
        roughness=jnp.concatenate([mats.roughness, jnp.asarray([0.0],
                                                               jnp.float32)]),
        flags=jnp.concatenate([mats.flags, jnp.asarray([0], jnp.int32)]),
        tex_id=jnp.concatenate([mats.tex_id, jnp.asarray([-1], jnp.int32)]),
        nmap_id=jnp.concatenate([mats.nmap_id,
                                 jnp.asarray([-1], jnp.int32)]),
    )
    mi = scene.materials.flags.shape[0]
    scene = dataclasses.replace(
        scene,
        materials=new_mats,
        sph_center=_cat(scene.sph_center, (0.0, -1.0, -5.0)),
        sph_radius=jnp.concatenate([scene.sph_radius,
                                    jnp.asarray([2.2], jnp.float32)]),
        sph_mat=jnp.concatenate([scene.sph_mat, jnp.asarray([mi], jnp.int32)]),
    )
    cp = camera_arrays(Camera())
    Wl = Hl = 12
    img_nee = np.asarray(render(scene, cp, Wl, Hl, 256, 11, max_bounces=6,
                                live_cutoff=None, physical=True, nee=True))
    img_bsdf = np.asarray(render(scene, cp, Wl, Hl, 4096, 11, max_bounces=6,
                                 live_cutoff=None, physical=True, nee=False))
    m_nee, m_bsdf = img_nee.mean(), img_bsdf.mean()
    assert abs(m_nee - m_bsdf) / m_nee < 0.06, (m_nee, m_bsdf)


def test_phong_pdf_matches_sampler():
    """phong_pdf IS the density of phong_direction's samples: for a test
    functional g, E_samples[g(w)] == MC-integral of g(w) phong_pdf(w) over
    the sphere (uniform-direction quadrature). Also checks normalization
    (g == 1) and the unnormalized-axis case the reference's mirror
    directions produce."""
    from cuda_path_tracer_ss.ops.sampling import (phong_direction,
                                                      phong_lobe_axis,
                                                      phong_pdf)
    n = 200000
    k = jax.random.PRNGKey(7)
    for exponent, axis_raw in [
            (8.0, (0.3, 0.8, -0.4)),
            (80.0, (0.0, -1.0, 0.1)),
            (0.0, (1.0, 0.2, 0.0)),
            # unnormalized axis (the inside-hit mirror quirk's shape)
            (12.0, (0.5, 1.3, -0.9)),
    ]:
        ax = Vec3(*(jnp.full((n,), c, jnp.float32) for c in axis_raw))
        e = jnp.full((n,), exponent, jnp.float32)
        u1, u2 = (_uniforms(jax.random.fold_in(k, i), n) for i in (0, 1))
        w = phong_direction(ax, e, u1, u2)
        axis_unit = phong_lobe_axis(ax)

        def g(v):
            return (1.0 + v.dot(axis_unit)) ** 2

        sample_mean = float(jnp.mean(g(w)))

        # uniform directions on the sphere for the pdf-side integral
        z = 1.0 - 2.0 * _uniforms(jax.random.fold_in(k, 2), n)
        phi = _uniforms(jax.random.fold_in(k, 3), n) * (2.0 * np.pi)
        r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        u = Vec3(r * jnp.cos(phi), z, r * jnp.sin(phi))
        pdf = phong_pdf(axis_unit, e, u)
        integral = float(jnp.mean(g(u) * pdf) * 4.0 * np.pi)
        norm = float(jnp.mean(pdf) * 4.0 * np.pi)

        assert abs(norm - 1.0) < 0.02, (exponent, norm)
        assert abs(integral - sample_mean) / sample_mean < 0.03, (
            exponent, integral, sample_mean)


def test_shade_physical_glossy_matches_quadrature():
    """The glossy NEE term == quadrature of its integrand
    prob * spec * phong_pdf(w) * L_e |cos_l| A / d^2 over the light
    (diffuse lobe zeroed to isolate it)."""
    from cuda_path_tracer_ss.ops.sampling import phong_lobe_axis
    from cuda_path_tracer_ss.ops.shading import GlossLobe

    scene = presets.cornell_empty()
    floor_y = float(jnp.min(scene.tri_v0.y))
    n = 120000
    px = np.array([0.4, floor_y + 0.6, -5.2])
    point = Vec3(*(jnp.full((n,), c, jnp.float32) for c in px))
    normal = Vec3(jnp.zeros((n,)), jnp.ones((n,)), jnp.zeros((n,)))
    zero3 = Vec3.zeros((n,))
    diff_avg = jnp.zeros((n,))

    axis_raw = np.array([0.25, 1.0, 0.3])
    ax = Vec3(*(jnp.full((n,), c, jnp.float32) for c in axis_raw))
    exponent, prob = 14.0, 0.45
    spec = (0.9, 0.7, 0.5)
    gloss = GlossLobe(axis=phong_lobe_axis(ax),
                      exponent=jnp.full((n,), exponent),
                      weight=Vec3(*(jnp.full((n,), c) for c in spec)),
                      prob=jnp.full((n,), prob))

    k = jax.random.PRNGKey(3)
    rows = jnp.stack([_uniforms(jax.random.fold_in(k, i), n)
                      for i in range(4 * scene.num_area_lights)])
    mc = shade_physical(scene, point, normal, zero3, diff_avg, rows,
                        gloss=gloss)
    mc_rgb = np.array([float(v.mean()) for v in
                       (np.asarray(mc.x), np.asarray(mc.y), np.asarray(mc.z))])

    # quadrature over the light with the same phong_pdf (evaluated via the
    # same jax helper on the grid points, so only the measure math is tested)
    from cuda_path_tracer_ss.ops.sampling import phong_pdf
    total = np.zeros(3)
    for li in range(scene.num_area_lights):
        tri0 = int(scene.al_tri0[li])
        mat = int(scene.tri_mat[tri0])
        l_e = np.array([float(scene.materials.emission.x[mat]),
                        float(scene.materials.emission.y[mat]),
                        float(scene.materials.emission.z[mat])])
        for t in (tri0, tri0 + 1):
            v0, v1, v2 = [np.array([float(v.x[t]), float(v.y[t]),
                                    float(v.z[t])])
                          for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
            n_raw = np.cross(v1 - v0, v2 - v0)
            area = 0.5 * np.linalg.norm(n_raw)
            n_l = n_raw / np.linalg.norm(n_raw)
            g = 120
            pts = []
            for i in range(g):
                for j in range(g - i):
                    w1, w2 = (i + 1 / 3) / g, (j + 1 / 3) / g
                    pts.append(v0 * (1 - w1 - w2) + v1 * w1 + v2 * w2)
            pts = np.asarray(pts)
            off = pts - px
            d2 = (off * off).sum(-1)
            w = off / np.sqrt(d2)[:, None]
            m = pts.shape[0]
            wv = Vec3(jnp.asarray(w[:, 0], jnp.float32),
                      jnp.asarray(w[:, 1], jnp.float32),
                      jnp.asarray(w[:, 2], jnp.float32))
            ax1 = Vec3(*(jnp.full((m,), c, jnp.float32) for c in axis_raw))
            pdf = np.asarray(phong_pdf(
                phong_lobe_axis(ax1), jnp.full((m,), exponent), wv))
            cl = np.abs(w @ n_l)
            acc = (prob * pdf * cl / d2).sum()
            total += l_e * np.asarray(spec) * acc * (area / m)
    np.testing.assert_allclose(mc_rgb, total, rtol=0.04)


def test_beckmann_pdf_matches_sampler():
    """beckmann_pdf IS the density of beckmann_direction's samples. Two
    links: (a) the sampler's empirical cap CDF matches the closed form
    F(t0) = 1 - exp(-tan(t0)/r^2) implied by its inverse-CDF construction;
    (b) 1-D theta-quadrature of beckmann_pdf * 2 pi sin(theta) matches the
    same closed form — together they tie pdf <-> sampler. Includes the
    unnormalized-axis case (raw triangle surfel normals)."""
    from cuda_path_tracer_ss.ops.sampling import (beckmann_direction,
                                                      beckmann_pdf,
                                                      phong_lobe_axis)
    n = 200000
    k = jax.random.PRNGKey(13)
    for roughness, axis_raw in [
            (0.4, (0.0, 1.0, 0.0)),
            (0.9, (0.3, 0.8, -0.4)),
            (1.6, (0.0, -1.0, 0.1)),
            # unnormalized axis (triangle surfel normals arrive raw)
            (0.7, (0.5, 1.3, -0.9)),
    ]:
        ax = Vec3(*(jnp.full((n,), c, jnp.float32) for c in axis_raw))
        r = jnp.full((n,), roughness, jnp.float32)
        u1, u2 = (_uniforms(jax.random.fold_in(k, i), n) for i in (0, 1))
        m = beckmann_direction(ax, r, u1, u2)
        axis_unit = phong_lobe_axis(ax)
        cos_t = np.asarray(m.dot(axis_unit))

        # (a) sampler's cap CDF vs the closed form
        def closed(t):
            return 1.0 - np.exp(-np.tan(t) / roughness ** 2)

        for theta0 in (0.3, 0.7, 1.2):
            empirical = float((cos_t >= np.cos(theta0)).mean())
            assert abs(empirical - closed(theta0)) < 0.01, (roughness, theta0)

        # (b) theta-quadrature of the pdf over [0.3, 1.2] (away from the
        # integrable 1/sin pole at the axis, where f32 cos^2 also loses
        # precision) vs closed-form CDF differences
        thetas = np.linspace(0.3, 1.2, 2000)
        grid = Vec3(jnp.asarray(np.sin(thetas), jnp.float32),
                    jnp.asarray(np.cos(thetas), jnp.float32),
                    jnp.zeros((thetas.size,), jnp.float32))
        y_axis = Vec3(jnp.zeros((thetas.size,)),
                      jnp.ones((thetas.size,)),
                      jnp.zeros((thetas.size,)))
        pdf_1d = np.asarray(beckmann_pdf(
            y_axis, jnp.full((thetas.size,), roughness), grid))
        dens_theta = pdf_1d * 2.0 * np.pi * np.sin(thetas)
        for t0, t1 in ((0.3, 0.7), (0.7, 1.2)):
            sel = (thetas >= t0) & (thetas <= t1)
            quad = float(np.trapezoid(dens_theta[sel], thetas[sel]))
            want = closed(t1) - closed(t0)
            assert abs(quad - want) < 0.005, (roughness, t0, t1, quad, want)


def test_shade_physical_ct_matches_quadrature():
    """The Cook-Torrance NEE term == quadrature of its integrand
    prob * spec * G(h)/nv * p_ct(w) * L_e |cos_l| A / d^2 over the light,
    with pdf and G re-derived independently in numpy (diffuse and Phong
    lobes zeroed to isolate it)."""
    from cuda_path_tracer_ss.ops.shading import CTLobe

    scene = presets.cornell_empty()
    floor_y = float(jnp.min(scene.tri_v0.y))
    n = 120000
    px = np.array([-0.3, floor_y + 0.7, -5.5])
    point = Vec3(*(jnp.full((n,), c, jnp.float32) for c in px))
    normal_raw = np.array([0.1, 1.2, -0.2])  # raw (unnormalized) surfel normal
    normal = Vec3(*(jnp.full((n,), c, jnp.float32) for c in normal_raw))
    zero3 = Vec3.zeros((n,))
    diff_avg = jnp.zeros((n,))

    d_in = np.array([0.55, -0.75, -0.37])
    d_in = d_in / np.linalg.norm(d_in)
    cos_i = float(-d_in @ normal_raw)
    nv = max(abs(cos_i), 1e-6)
    roughness, prob = 0.6, 0.5
    spec = (0.8, 0.9, 0.6)

    axis_unit = normal_raw / np.linalg.norm(normal_raw)
    ct = CTLobe(
        axis=Vec3(*(jnp.full((n,), c, jnp.float32) for c in axis_unit)),
        roughness=jnp.full((n,), roughness),
        weight=Vec3(*(jnp.full((n,), c) for c in spec)),
        prob=jnp.full((n,), prob),
        d=Vec3(*(jnp.full((n,), c, jnp.float32) for c in d_in)),
        normal=normal,
        nv=jnp.full((n,), nv))

    k = jax.random.PRNGKey(17)
    rows = jnp.stack([_uniforms(jax.random.fold_in(k, i), n)
                      for i in range(4 * scene.num_area_lights)])
    mc = shade_physical(scene, point, normal, zero3, diff_avg, rows, ct=ct)
    mc_rgb = np.array([float(np.asarray(v).mean())
                       for v in (mc.x, mc.y, mc.z)])

    def np_ct_f_cos(w):  # independent reimplementation of the integrand
        h = w - d_in
        h = h / np.linalg.norm(h, axis=-1, keepdims=True)
        cos_t = h @ axis_unit
        sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 1e-12))
        tan_t = sin_t / np.maximum(cos_t, 1e-12)
        r2 = roughness ** 2
        p_m = np.where(cos_t > 0,
                       np.exp(-tan_t / r2) * (1 + tan_t ** 2)
                       / (2 * np.pi * r2 * sin_t), 0.0)
        dh = np.maximum(np.abs(h @ d_in), 1e-12)
        p_dir = p_m / (4 * dh)
        nh = np.abs(h @ normal_raw)
        nl = np.abs(w @ normal_raw)
        G = np.minimum(np.minimum(1.0, 2 * nh * nl / dh), 2 * nh * nv / dh)
        return prob * p_dir * G / nv  # times spec color outside

    total = np.zeros(3)
    for li in range(scene.num_area_lights):
        tri0 = int(scene.al_tri0[li])
        mat = int(scene.tri_mat[tri0])
        l_e = np.array([float(scene.materials.emission.x[mat]),
                        float(scene.materials.emission.y[mat]),
                        float(scene.materials.emission.z[mat])])
        for t in (tri0, tri0 + 1):
            v0, v1, v2 = [np.array([float(v.x[t]), float(v.y[t]),
                                    float(v.z[t])])
                          for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
            n_raw = np.cross(v1 - v0, v2 - v0)
            area = 0.5 * np.linalg.norm(n_raw)
            n_l = n_raw / np.linalg.norm(n_raw)
            g = 120
            pts = []
            for i in range(g):
                for j in range(g - i):
                    w1, w2 = (i + 1 / 3) / g, (j + 1 / 3) / g
                    pts.append(v0 * (1 - w1 - w2) + v1 * w1 + v2 * w2)
            pts = np.asarray(pts)
            off = pts - px
            d2 = (off * off).sum(-1)
            w = off / np.sqrt(d2)[:, None]
            cl = np.abs(w @ n_l)
            acc = (np_ct_f_cos(w) * cl / d2).sum()
            total += l_e * np.asarray(spec) * acc * (area / pts.shape[0])
    np.testing.assert_allclose(mc_rgb, total, rtol=0.04)


@pytest.mark.slow
def test_physical_ct_estimators_agree():
    """Cook-Torrance MIS unbiasedness: on a scene with a rough Beckmann
    sphere (flags=3), NEE+MIS (which now light-samples the CT lobe) and
    pure BSDF sampling estimate the same image — the MIS weights for the
    reflection branch are exactly complementary, and the sampler's quirk
    branch (d.m > 0) keeps full emission weight."""
    from cuda_path_tracer_ss.models.presets import add_cornell_box
    from cuda_path_tracer_ss.models.scene import (MaterialSpec,
                                                      SceneBuilder)
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(
        diffuse=(0.15, 0.15, 0.3), diff_avg=0.2,
        specular=(0.9, 0.75, 0.5), spec_avg=0.65,
        roughness=0.55, flags=3))
    b.add_sphere((0.0, -2.0, -5.0), 1.9, m)
    add_cornell_box(b, 8.0)
    scene = b.build()

    cp = camera_arrays(Camera())
    W = H = 12
    img_nee = np.asarray(render(scene, cp, W, H, 256, 21, max_bounces=5,
                                live_cutoff=None, physical=True, nee=True))
    img_bsdf = np.asarray(render(scene, cp, W, H, 4096, 21, max_bounces=5,
                                 live_cutoff=None, physical=True, nee=False))
    m_nee, m_bsdf = img_nee.mean(), img_bsdf.mean()
    assert abs(m_nee - m_bsdf) / m_nee < 0.05, (m_nee, m_bsdf)


@pytest.mark.slow
def test_physical_glossy_estimators_agree():
    """Glossy-lobe MIS unbiasedness: on a scene with a Phong specular
    sphere, NEE+MIS (which now light-samples the glossy lobe too) and pure
    BSDF sampling estimate the same image; and the glossy NEE must not
    double-count (the MIS weights are exactly complementary)."""
    from cuda_path_tracer_ss.models.presets import add_cornell_box
    from cuda_path_tracer_ss.models.scene import (MaterialSpec,
                                                      SceneBuilder)
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(
        diffuse=(0.2, 0.2, 0.5), diff_avg=0.25,
        specular=(0.9, 0.8, 0.6), spec_exp=40.0, spec_avg=0.65, ior=2.8))
    b.add_sphere((0.0, -2.0, -5.0), 1.9, m)
    add_cornell_box(b, 8.0)
    scene = b.build()

    cp = camera_arrays(Camera())
    W = H = 12
    img_nee = np.asarray(render(scene, cp, W, H, 256, 5, max_bounces=5,
                                live_cutoff=None, physical=True, nee=True))
    img_bsdf = np.asarray(render(scene, cp, W, H, 4096, 5, max_bounces=5,
                                 live_cutoff=None, physical=True, nee=False))
    m_nee, m_bsdf = img_nee.mean(), img_bsdf.mean()
    assert abs(m_nee - m_bsdf) / m_nee < 0.05, (m_nee, m_bsdf)
