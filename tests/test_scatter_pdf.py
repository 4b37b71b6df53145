"""scatter_lobe_pdfs (ops/bsdf.py) vs the scatter() sampler itself.

For each branch label, the labeled effective density integrated over a
solid-angle region must equal the probability that scatter() fires that
label into the region:  P[label & w in R]  ==  \\int_R p_label(w) dw.
The left side is a sample frequency over scatter() draws; the right side
is Monte-Carlo quadrature over uniform sphere directions. This validates
the branch-probability x lobe-density composition (the prev_pdf convention
the physical MIS and the bidirectional pdfs rely on) end to end —
phong_pdf/beckmann_pdf alone are covered by tests/test_sampling.py.
"""
import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.ops.bsdf import (
    MaterialLookup, scatter, scatter_lobe_pdfs)
from cuda_path_tracer_ss.ops.vec import Vec3

N_SAMPLES = 200_000
N_QUAD = 400_000


def _v3(n, t):
    return Vec3(jnp.full((n,), t[0], jnp.float32),
                jnp.full((n,), t[1], jnp.float32),
                jnp.full((n,), t[2], jnp.float32))


def _mat(n, **kw):
    d = dict(diffuse=(0.5, 0.5, 0.5), specular=(0.8, 0.8, 0.8),
             absorption=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
             spec_exp=np.inf, ior=1.5, diff_avg=0.3, spec_avg=0.4,
             refr_avg=0.0, roughness=0.0, flags=0)
    d.update(kw)
    return MaterialLookup(
        diffuse=_v3(n, d["diffuse"]), specular=_v3(n, d["specular"]),
        absorption=_v3(n, d["absorption"]), emission=_v3(n, d["emission"]),
        spec_exp=jnp.full((n,), d["spec_exp"], jnp.float32),
        ior=jnp.full((n,), d["ior"], jnp.float32),
        diff_avg=jnp.full((n,), d["diff_avg"], jnp.float32),
        spec_avg=jnp.full((n,), d["spec_avg"], jnp.float32),
        refr_avg=jnp.full((n,), d["refr_avg"], jnp.float32),
        roughness=jnp.full((n,), d["roughness"], jnp.float32),
        flags=jnp.full((n,), d["flags"], jnp.int32))


_D_IN = np.array([0.4, -0.7, 0.2])
_D_IN = _D_IN / np.linalg.norm(_D_IN)
_NORMAL = np.array([0.0, 1.0, 0.0])
_MIRROR = _D_IN - 2.0 * np.dot(_D_IN, _NORMAL) * _NORMAL  # unit


def _setup(n, **mat_kw):
    rng = np.random.RandomState(7)
    d = _v3(n, _D_IN)
    nrm = _v3(n, _NORMAL)
    cos_i = (-d).dot(nrm)
    m = _mat(n, **mat_kw)
    u = [jnp.asarray(rng.random_sample(n), jnp.float32) for _ in range(3)]
    sc = scatter(d, Vec3.zeros((n,)), nrm, m, cos_i, *u)
    return d, nrm, cos_i, m, sc


def _quad_region_mass(axis_lo, mat_kw, label, lo_cos, hi_cos):
    """4pi * E_uniform[p_label(w) * 1{lo_cos <= w.axis <= hi_cos}]
    with its standard error."""
    rng = np.random.RandomState(13)
    w_np = rng.normal(size=(N_QUAD, 3))
    w_np /= np.linalg.norm(w_np, axis=1, keepdims=True)
    w = Vec3(*(jnp.asarray(w_np[:, i], jnp.float32) for i in range(3)))
    d = _v3(N_QUAD, _D_IN)
    nrm = _v3(N_QUAD, _NORMAL)
    cos_i = (-d).dot(nrm)
    m = _mat(N_QUAD, **mat_kw)
    p_diff, p_gloss, p_ct = scatter_lobe_pdfs(d, nrm, m, cos_i, w)
    p = {"diff": p_diff, "gloss": p_gloss, "ct": p_ct}[label]
    c = np.asarray(w.dot(_v3(N_QUAD, axis_lo)))
    vals = np.asarray(p) * ((c >= lo_cos) & (c <= hi_cos)) * 4.0 * np.pi
    return vals.mean(), vals.std() / np.sqrt(N_QUAD)


def _freq(mask, extra=None):
    hit = np.asarray(mask)
    if extra is not None:
        hit = hit & np.asarray(extra)
    p = hit.mean()
    return p, np.sqrt(p * (1.0 - p) / len(hit))


def _check(freq_pair, quad_pair):
    (f, sf), (q, sq) = freq_pair, quad_pair
    tol = 6.0 * np.sqrt(sf * sf + sq * sq) + 1e-4
    assert abs(f - q) < tol, (f, q, tol)
    assert q > 0.01  # the region actually carries mass


def test_diffuse_label_region_mass():
    kw = dict(diff_avg=0.3, spec_avg=0.4, spec_exp=20.0, flags=0)
    _, nrm, _, _, sc = _setup(N_SAMPLES, **kw)
    wn = sc.direction.normalize(eps=1e-12)
    in_cap = np.asarray(wn.dot(nrm)) >= 0.5          # 60-degree cap
    _check(_freq(sc.diffuse_branch, in_cap),
           _quad_region_mass(_NORMAL, kw, "diff", 0.5, 1.0))


def test_phong_gloss_label_region_mass():
    kw = dict(diff_avg=0.3, spec_avg=0.4, spec_exp=20.0, flags=0)
    n = N_SAMPLES
    _, _, _, _, sc = _setup(n, **kw)
    wn = sc.direction.normalize(eps=1e-12)
    c = np.asarray(wn.dot(_v3(n, _MIRROR)))
    in_cap = c >= np.cos(np.radians(30.0))
    _check(_freq(sc.gloss_branch, in_cap),
           _quad_region_mass(_MIRROR, kw, "gloss",
                             float(np.cos(np.radians(30.0))), 1.0))


def test_cook_torrance_label_region_mass():
    # Ring around the mirror direction, excluding the 1/sin pole at its
    # center (beckmann_pdf docstring) so the quadrature variance is finite.
    kw = dict(diff_avg=0.2, spec_avg=0.6, roughness=0.5, flags=2)
    n = N_SAMPLES
    d, _, _, _, sc = _setup(n, **kw)
    wn = sc.direction.normalize(eps=1e-12)
    # only the reflection preimage (d.m < 0) carries density, by convention
    m_half = (wn - d).normalize(eps=1e-12)
    refl_branch = np.asarray(d.dot(m_half)) < 0.0
    lo, hi = np.cos(np.radians(60.0)), np.cos(np.radians(10.0))
    c = np.asarray(wn.dot(_v3(n, _MIRROR)))
    in_ring = (c >= lo) & (c <= hi)
    _check(_freq(sc.ct_branch, in_ring & refl_branch),
           _quad_region_mass(_MIRROR, kw, "ct", float(lo), float(hi)))


def test_delta_and_refraction_labels_score_zero():
    # mirror (infinite exponent), zero-roughness CT, and refraction are
    # delta/unscored: every labeled density must be finite and the
    # gloss/ct densities identically 0
    for kw in (dict(diff_avg=0.0, spec_avg=1.0, spec_exp=np.inf, flags=0),
               dict(diff_avg=0.0, spec_avg=1.0, roughness=0.0, flags=2),
               dict(diff_avg=0.0, spec_avg=0.0, refr_avg=1.0)):
        n = 4096
        d, nrm, cos_i, m, sc = _setup(n, **kw)
        p_diff, p_gloss, p_ct = scatter_lobe_pdfs(d, nrm, m, cos_i,
                                                  sc.direction)
        for p in (p_diff, p_gloss, p_ct):
            assert bool(jnp.all(jnp.isfinite(p)))
        assert float(jnp.max(p_gloss)) == 0.0
        assert float(jnp.max(p_ct)) == 0.0
