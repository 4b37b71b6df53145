"""Color and normal mapping — the last feature the reference slated
(README.md:35 "color/normal mapping") but never built.

Design (both engines: this module is the jnp form AND the behavioral spec
the fused kernel's ``_texture_block`` mirrors formula-for-formula with
per-lane texel gathers; tests/test_texture.py asserts per-pixel parity):

* **UV source** — triangles carry per-corner UVs (``Scene.tri_uv*``,
  barycentrically interpolated exactly like the shading normals,
  Primitives.h:71-73 semantics); spheres use a procedural spherical
  parameterization of the hit normal (``sphere_uv``), so any sphere is
  texturable with zero stored data.
* **Color map** — bilinear, wrap-around sample of ``Scene.textures[tex_id]``
  modulates the material's diffuse albedo at the hit. Only the albedo: the
  reference's weights-double-as-probabilities quirk means ``diff_avg``
  stays the (untextured) branch probability, so texturing never changes
  which paths are traced — it reweights them. That keeps the estimator's
  RNG stream consumption identical with and without textures.
* **Normal map** — tangent-space texel (2c - 1) rotated into the surface
  frame: the tangent follows the UV parameterization (solved from the
  triangle's edge/UV deltas; analytic for spheres), orthonormalized
  against the interpolated shading normal.
* **Differentiable** — the bilinear gather is differentiable w.r.t. the
  texel values, so ``inverse.invert(..., ["textures"])`` recovers texture
  CONTENT from renders (tested in tests/test_texture.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .vec import Vec3, where as vwhere


def sample_bilinear(textures, tex_hw, tid, u, v):
    """Bilinear, wrap-around texture sample.

    ``textures``: [K, TH, TW, 3] padded atlas; ``tex_hw``: [K, 2] true
    (h, w); ``tid``: [N] int32 texture index (callers mask tid < 0
    themselves); ``u, v``: [N] texture coordinates, v = 0 at the BOTTOM of
    the image (OBJ convention; images load top-row-first, so v flips).
    Returns Vec3 of [N]."""
    k = jnp.clip(tid, 0, textures.shape[0] - 1)
    h = tex_hw[k, 0].astype(jnp.float32)
    w = tex_hw[k, 1].astype(jnp.float32)
    # wrap to [0,1) then to continuous texel coordinates, texel centers at
    # integer+0.5
    uu = (u - jnp.floor(u)) * w - 0.5
    vv = (1.0 - (v - jnp.floor(v))) * h - 0.5
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fx = uu - x0
    fy = vv - y0

    def texel(xi, yi):
        hi = tex_hw[k, 0]
        wi = tex_hw[k, 1]
        x = jnp.mod(xi.astype(jnp.int32), wi)
        y = jnp.mod(yi.astype(jnp.int32), hi)
        return textures[k, y, x]                     # [N, 3]

    c = (texel(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
         + texel(x0 + 1, y0) * (fx * (1 - fy))[..., None]
         + texel(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
         + texel(x0 + 1, y0 + 1) * (fx * fy)[..., None])
    return Vec3(c[..., 0], c[..., 1], c[..., 2])


def atanf(x):
    """Branchless float32 arctangent (Cephes atanf coefficients, max error
    ~1e-7) from elementwise primitives: cross-engine per-pixel texture
    parity requires BOTH engines (XLA and the fused kernel) to evaluate the
    SAME formula, so both use this one (sphere_uv)."""
    ax = jnp.abs(x)
    big = ax > 2.414213562373095    # tan(3 pi / 8)
    mid = ax > 0.4142135623730950   # tan(pi / 8)
    # guard floor 1e-12 (round 5; was 1e-30): -1/safe_ax only SELECTS when
    # ax > 2.41, so the clamp never changes a value — but its DERIVATIVE
    # 1/ax^2 is computed for every lane, overflowed to inf below ax ~
    # 1e-19, and 0 * inf through the where poisoned reverse-mode AD of
    # every atanf/asinf/atan2f consumer (sphere-uv gradients NaN'd at
    # ax = 0 exactly — the textured-sphere geometry-training find)
    safe_ax = jnp.maximum(ax, 1e-12)
    t = jnp.where(big, -1.0 / safe_ax,
                  jnp.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    y0 = jnp.where(big, jnp.pi / 2, jnp.where(mid, jnp.pi / 4, 0.0))
    z = t * t
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * t + t
    return jnp.sign(x) * (y0 + p)


def atan2f(y, x):
    """Four-quadrant arctangent built on :func:`atanf` (same reasoning).

    The x-guard floor is 1e-12 (round 5; was 1e-30): the quotient's
    gradient carries -y/x^2, which overflows to inf for 1e-30 < |x| <
    ~1e-19 and then NaNs reverse-mode AD through 0*inf — exactly the uv
    pole of a textured sphere (sphere_uv feeds n.x here). At the floor
    the gradient caps at ~1e24 (finite) and the clamped branch carries
    zero gradient. Both engines share this function, so the value change
    (only where |x| < 1e-12 — the uv seam's sub-pixel neighborhood)
    keeps cross-engine per-pixel parity intact."""
    ax = jnp.abs(x)
    safe_x = jnp.where(ax < 1e-12, jnp.where(x < 0.0, -1e-12, 1e-12), x)
    a = atanf(y / safe_x)
    return jnp.where(x < 0.0,
                     a + jnp.where(y >= 0.0, jnp.pi, -jnp.pi), a)


def asinf(x):
    """arcsin on [-1, 1] via atanf (same reasoning)."""
    xc = jnp.clip(x, -1.0, 1.0)
    return atanf(xc / jnp.sqrt(jnp.maximum(1.0 - xc * xc, 1e-12)))


def sphere_uv(n: Vec3):
    """Spherical parameterization of a unit normal: u wraps longitude
    (atan2 around +y), v runs latitude 0 (south pole) -> 1 (north).
    Uses the shared polynomial atan2/asin so the Pallas engine computes
    identical UVs (see atanf)."""
    two_pi = 2.0 * jnp.pi
    u = 0.5 + atan2f(n.z, n.x) / two_pi
    v = 0.5 + asinf(n.y) / jnp.pi
    return u, v


def _sphere_tangent(n: Vec3):
    """d(position)/du direction of sphere_uv — longitude circles — with a
    pole fallback. Uses the gradient-clamped normalize: near the poles
    the tangent's norm vanishes and a plain normalize makes inf gradient
    factors — even a ZERO cotangent (no normal map in use) times inf is
    NaN, which poisoned geometry gradients on textured spheres (round-5
    phase-2 find). Values are bit-identical to the plain normalize."""
    t = Vec3(-n.z, jnp.zeros_like(n.y), n.x)
    degen = t.norm2() < 1e-12
    fallback = Vec3(jnp.ones_like(n.x), jnp.zeros_like(n.y),
                    jnp.zeros_like(n.z))
    return vwhere(degen, fallback, t.normalize_clamped_grad(eps=1e-20))


def apply_maps(scene, ro: Vec3, rd: Vec3, hit, surfel, m):
    """Texture the per-lane material/surfel: returns (m', surfel') with the
    diffuse albedo modulated by the color map and the shading normal
    perturbed by the normal map (lanes whose material maps are -1 pass
    through untouched). One extra barycentric evaluation per bounce; no
    effect on RNG stream consumption."""
    S, T = scene.num_spheres, scene.num_triangles
    is_tri = hit.prim >= S
    n_unit = surfel.normal.normalize(eps=1e-20)

    u = jnp.zeros_like(hit.t)
    v = jnp.zeros_like(hit.t)
    tang = Vec3(jnp.ones_like(hit.t), jnp.zeros_like(hit.t),
                jnp.zeros_like(hit.t))

    if S:
        su, sv = sphere_uv(n_unit)
        st = _sphere_tangent(n_unit)
        u = jnp.where(~is_tri, su, u)
        v = jnp.where(~is_tri, sv, v)
        tang = vwhere(~is_tri, st, tang)

    if T:
        from .intersect import triangle_t
        ti = jnp.clip(hit.prim - S, 0, T - 1)
        v0 = Vec3(scene.tri_v0.x[ti], scene.tri_v0.y[ti], scene.tri_v0.z[ti])
        v1 = Vec3(scene.tri_v1.x[ti], scene.tri_v1.y[ti], scene.tri_v1.z[ti])
        v2 = Vec3(scene.tri_v2.x[ti], scene.tri_v2.y[ti], scene.tri_v2.z[ti])
        _, w1, w2, _ = triangle_t(ro, rd, v0, v1, v2)
        w0 = 1.0 - (w1 + w2)
        uv0 = scene.tri_uv0[ti]
        uv1 = scene.tri_uv1[ti]
        uv2 = scene.tri_uv2[ti]
        tu = uv0[:, 0] * w0 + uv1[:, 0] * w1 + uv2[:, 0] * w2
        tv = uv0[:, 1] * w0 + uv1[:, 1] * w1 + uv2[:, 1] * w2
        u = jnp.where(is_tri, tu, u)
        v = jnp.where(is_tri, tv, v)
        # UV-aligned tangent: T = (e1 dv2 - e2 dv1) / det
        e1 = v1 - v0
        e2 = v2 - v0
        du1 = uv1[:, 0] - uv0[:, 0]
        dv1 = uv1[:, 1] - uv0[:, 1]
        du2 = uv2[:, 0] - uv0[:, 0]
        dv2 = uv2[:, 1] - uv0[:, 1]
        det = du1 * dv2 - du2 * dv1
        det_bad = jnp.abs(det) < 1e-12
        inv_det = jnp.where(det_bad, 0.0,
                            1.0 / jnp.where(det_bad, 1.0, det))
        tt = (e1 * dv2 - e2 * dv1) * inv_det
        degen = det_bad | (tt.norm2() < 1e-16)
        # stable fallback frame for UV-less triangles
        tt = vwhere(degen, e1.normalize(eps=1e-20), tt)
        tang = vwhere(is_tri, tt, tang)

    tex_id = scene.materials.tex_id[surfel.mat]
    nmap_id = scene.materials.nmap_id[surfel.mat]

    new_m = m
    if scene.num_textures:
        albedo = sample_bilinear(scene.textures, scene.tex_hw, tex_id, u, v)
        scale = vwhere(tex_id >= 0, albedo, Vec3.ones(u.shape))
        new_m = m._replace(diffuse=m.diffuse * scale)

        texel = sample_bilinear(scene.textures, scene.tex_hw, nmap_id, u, v)
        # tangent frame orthonormalized against the shading normal —
        # gradient-clamped normalize: the projection can degenerate
        # (tang ~ parallel to n at the sphere poles), and the plain
        # normalize's inf gradient factors NaN the whole backward pass
        # through 0*inf even when no normal map consumes the frame
        # (round-5 phase-2 find). Values are bit-identical.
        t_ortho = (tang - n_unit * n_unit.dot(tang)
                   ).normalize_clamped_grad(eps=1e-20)
        b = n_unit.cross(t_ortho)
        tn = texel * 2.0 - 1.0
        perturbed = (t_ortho * tn.x + b * tn.y
                     + n_unit * jnp.maximum(tn.z, 1e-3)).normalize(eps=1e-20)
        # preserve the UNNORMALIZED interpolated-normal convention for
        # unmapped lanes (Primitives.h:71-73); mapped lanes get the unit
        # perturbed normal scaled back to the original length so downstream
        # cos/normalize behavior matches either way
        n_len = jnp.sqrt(jnp.maximum(surfel.normal.norm2(), 1e-20))
        new_n = vwhere(nmap_id >= 0, perturbed * n_len, surfel.normal)
        surfel = surfel._replace(normal=new_n)
    return new_m, surfel
