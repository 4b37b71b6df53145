"""Whole-render Pallas-Triton kernel: eye rays + all samples + all bounces
in ONE kernel launch, one GPU thread per ray.

This is the reference's own design (``CudaTracer.cu:106-206``, one CUDA
thread per ray, the scene read from global memory) with the per-bounce
launches folded into one: each Triton program owns a ``tile`` of pixels,
keeps every ray's whole path (all samples, all bounces) in registers, and
writes three radiance-sum vectors to device memory once. The scene, camera
and texture tables (KBs) are ordinary global-memory inputs read with scalar
loads (primitive sweeps) and per-lane gathers (materials, texels); they
stay resident in L1/L2.

Persistent path regeneration replaces the reference's ``thrust::partition``
compaction and its 128-live-ray cutoff (``CudaTracer.cu:621-632``): the
moment a lane's path ends it starts that pixel's next sample, so lanes do
not idle until their own sample budget is spent, and a program exits when
all of its lanes are done.

RNG: counter-based Threefry-2x32 on (seed, pixel, sample, pair) — the SAME
streams the jnp estimator consumes (utils/rng.py), replacing the reference's
per-pixel cuRAND states. The two engines therefore agree per pixel (up to
float op-order and last-bit transcendental differences), and any device
mesh renders bitwise the same image as one card.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...constants import INV_PI, RAY_BUMP_EPSILON
from ...utils import rng

# primitive/material table row widths (the pack_scene <-> kernel contract)
S_COLS = 5
T_COLS = 19
M_COLS = 20

# Rays per program and warps per program (a power of two: Triton's blocks
# are). One ray per thread keeps the ~20 live per-ray carries plus the
# shading temporaries in registers; two rays per thread (256 x 4) spilled
# on the showcase scene (4.3x slower). Swept on an H100 (PERF.md): 64 x 2
# and 128 x 4 are within 2%.
TILE = 64
NUM_WARPS = 2

# Sweeps unroll fully up to this primitive count; above it they become
# dynamic fori_loops over UNROLL_CHUNK primitives per iteration (+ a static
# tail). Measured on an H100 (PERF.md): unrolling the showcase's 36
# primitives fully was 27% slower and compiled 3x longer than chunked
# loops; a limit of 8 compiles the showcase in ~30 s at full speed.
UNROLL_LIMIT = 8
UNROLL_CHUNK = 8


class PackedScene:
    """Kernel-side scene bundles. A custom pytree: the arrays are leaves,
    ``counts`` (S, T, M, Lp, La) is static aux data so the kernel's unrolled
    loops specialize on it under jit. Empty bundles are padded to one zero
    row (the Pallas interpreter, which the CPU tests run, refuses 0-size
    operands); the dummy row is never read.

    Arrays: spheres [S,5] = cx cy cz r mat; triangles [T,19] = v0 e1 e2
    n0 n1 n2 mat (e1 = v1-v0, e2 = v2-v0 precomputed — the sweep would
    otherwise re-derive them per ray per bounce; per-corner normals are
    barycentrically interpolated exactly as Primitives.h:71-73);
    materials [M,20] = diff spec
    absorb emit specExp ior diffAvg specAvg refrAvg rough pureRefl ct;
    point_lights [Lp,6]; area_lights [La,23] = two triangles' vertices +
    power + owning-triangle index + light material index (the last two
    feed the physical estimator's emission-MIS lookups); background [3].

    Textured scenes add: ``texels`` [N, 3] every texture's texels,
    row-major, concatenated; ``tex_meta`` [K, 3] per texture (base, h, w);
    ``tex_triuv`` [T, 6] per-corner UVs; ``tex_matids`` [M, 2] color/normal
    map ids (-1 = none). ``tex_count`` = K is static.
    """

    __slots__ = ("spheres", "triangles", "materials", "point_lights",
                 "area_lights", "background", "counts", "texels",
                 "tex_meta", "tex_triuv", "tex_matids", "tex_count", "feat")

    def __init__(self, spheres, triangles, materials, point_lights,
                 area_lights, background, counts, texels=None,
                 tex_meta=None, tex_triuv=None, tex_matids=None,
                 tex_count=0, feat=(True, True, True)):
        self.spheres = spheres
        self.triangles = triangles
        self.materials = materials
        self.point_lights = point_lights
        self.area_lights = area_lights
        self.background = background
        self.counts = tuple(counts)
        self.texels = texels
        self.tex_meta = tex_meta
        self.tex_triuv = tex_triuv
        self.tex_matids = tex_matids
        self.tex_count = int(tex_count)
        # static material-feature flags (has_ct, has_finite_exp, has_refr):
        # pack_scene inspects the CONCRETE material table and the kernel
        # statically skips sampler blocks no material can take — bitwise
        # identical output (the skipped branches' masks are all-false).
        # Traced tables conservatively keep every branch.
        self.feat = tuple(feat)


def _packed_flatten(ps):
    return ((ps.spheres, ps.triangles, ps.materials, ps.point_lights,
             ps.area_lights, ps.background, ps.texels, ps.tex_meta,
             ps.tex_triuv, ps.tex_matids),
            (ps.counts, ps.tex_count, ps.feat))


def _packed_unflatten(aux, leaves):
    counts, tex_count, feat = aux
    return PackedScene(*leaves[:6], counts, texels=leaves[6],
                       tex_meta=leaves[7], tex_triuv=leaves[8],
                       tex_matids=leaves[9], tex_count=tex_count, feat=feat)


jax.tree_util.register_pytree_node(PackedScene, _packed_flatten,
                                   _packed_unflatten)


def pack_scene(scene) -> PackedScene:
    """Flatten the SoA scene into the kernel's table bundles."""
    def v3(v):
        return jnp.stack([v.x, v.y, v.z], -1)

    spheres = jnp.concatenate([
        v3(scene.sph_center),
        scene.sph_radius[:, None],
        scene.sph_mat[:, None].astype(jnp.float32),
    ], -1)

    v0 = v3(scene.tri_v0)
    tris = jnp.concatenate([
        v0, v3(scene.tri_v1) - v0, v3(scene.tri_v2) - v0,
        v3(scene.tri_n0), v3(scene.tri_n1), v3(scene.tri_n2),
        scene.tri_mat[:, None].astype(jnp.float32),
    ], -1)

    m = scene.materials
    mats = jnp.concatenate([
        v3(m.diffuse), v3(m.specular), v3(m.absorption), v3(m.emission),
        m.spec_exp[:, None], m.ior[:, None],
        m.diff_avg[:, None], m.spec_avg[:, None], m.refr_avg[:, None],
        m.roughness[:, None],
        ((m.flags & 0x01) != 0).astype(jnp.float32)[:, None],
        ((m.flags & 0x03) != 0).astype(jnp.float32)[:, None],
    ], -1)

    texels = tex_meta = tex_triuv = tex_matids = None
    tex_count = 0
    if getattr(scene, "num_textures", 0):
        K = scene.num_textures
        # STATIC metadata: read through NumPy — under a jit trace, jnp
        # indexing would stage ops and hand back tracers, but the sizes
        # must stay concrete. tex_hw is never trainable.
        hw_np = np.asarray(scene.tex_hw)
        flats, bases, off = [], [], 0
        for k in range(K):
            h, w = int(hw_np[k, 0]), int(hw_np[k, 1])
            bases.append(off)
            flats.append(scene.textures[k, :h, :w, :].reshape(h * w, 3))
            off += h * w
        texels = jnp.concatenate(flats, 0)                    # [total, 3]
        tex_meta = jnp.stack([
            jnp.asarray(bases, jnp.float32),
            jnp.asarray(hw_np[:, 0], jnp.float32),
            jnp.asarray(hw_np[:, 1], jnp.float32),
        ], -1)                                                # [K, 3]
        tex_triuv = jnp.concatenate(
            [scene.tri_uv0, scene.tri_uv1, scene.tri_uv2], -1)
        if not tex_triuv.shape[0]:
            tex_triuv = jnp.zeros((1, 6), jnp.float32)
        tex_matids = jnp.stack(
            [m.tex_id.astype(jnp.float32),
             m.nmap_id.astype(jnp.float32)], -1)
        tex_count = K

    if scene.num_point_lights:
        pls = jnp.concatenate([v3(scene.pl_pos), v3(scene.pl_power)], -1)
    else:
        pls = jnp.zeros((1, 6), jnp.float32)

    if scene.num_area_lights:
        t0 = scene.al_tri0
        t1 = scene.al_tri0 + 1
        gather = lambda v, i: jnp.stack([v.x[i], v.y[i], v.z[i]], -1)
        als = jnp.concatenate([
            gather(scene.tri_v0, t0), gather(scene.tri_v1, t0), gather(scene.tri_v2, t0),
            gather(scene.tri_v0, t1), gather(scene.tri_v1, t1), gather(scene.tri_v2, t1),
            v3(scene.al_power),
            # cols 21-22: owning triangle index + light material index —
            # the physical estimator's emission-MIS and L_e lookups need
            # them (integrator.py bounce / ops/shading.py shade_physical)
            t0[:, None].astype(jnp.float32),
            scene.tri_mat[t0][:, None].astype(jnp.float32),
        ], -1)
    else:
        als = jnp.zeros((1, 23), jnp.float32)

    def pad1(a):
        return a if a.shape[0] else jnp.zeros((1, a.shape[1]), a.dtype)

    counts = (scene.num_spheres, scene.num_triangles,
              scene.materials.flags.shape[0], scene.num_point_lights,
              scene.num_area_lights)
    try:
        flags_c = np.asarray(m.flags)
        feat = (bool(((flags_c & 0x03) != 0).any()),
                bool((np.isfinite(np.asarray(m.spec_exp))
                      & (np.asarray(m.spec_avg) > 0)).any()),
                bool((np.asarray(m.refr_avg) > 0).any()))
    except Exception:
        feat = (True, True, True)  # traced material table: keep everything

    bg = jnp.stack([scene.background.x, scene.background.y, scene.background.z])
    return PackedScene(pad1(spheres), pad1(tris), pad1(mats), pls, als,
                       bg.astype(jnp.float32), counts, texels=texels,
                       tex_meta=tex_meta, tex_triuv=tex_triuv,
                       tex_matids=tex_matids, tex_count=tex_count, feat=feat)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z, eps=1e-20):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, eps))
    return x * inv, y * inv, z * inv


def _rotate_y_to(tx, ty, tz, sx, sy, sz):
    """rotate +Y onto target t, applied to sample s (CudaTracer.cu:579-585)."""
    w = 1.0 + ty
    rx, ry, rz = tz, jnp.zeros_like(tz), -tx
    n2 = w * w + rx * rx + rz * rz
    degen = n2 < 1e-12
    inv = jax.lax.rsqrt(jnp.where(degen, 1.0, n2))
    w, rx, rz = w * inv, rx * inv, rz * inv
    # t = r x s + w*s
    t_x = ry * sz - rz * sy + w * sx
    t_y = rz * sx - rx * sz + w * sy
    t_z = rx * sy - ry * sx + w * sz
    ox = sx + 2.0 * (ry * t_z - rz * t_y)
    oy = sy + 2.0 * (rz * t_x - rx * t_z)
    oz = sz + 2.0 * (rx * t_y - ry * t_x)
    return (jnp.where(degen, sx, ox), jnp.where(degen, -sy, oy),
            jnp.where(degen, -sz, oz))


def _prim_loop(count, body, carry):
    """Fully unrolled below UNROLL_LIMIT; above it a dynamic fori_loop that
    processes UNROLL_CHUNK primitives per iteration (+ a static tail)."""
    if count <= UNROLL_LIMIT:
        for i in range(count):
            carry = body(i, carry)
        return carry

    n_chunks = count // UNROLL_CHUNK

    def chunk(c, cur):
        for k in range(UNROLL_CHUNK):
            cur = body(c * UNROLL_CHUNK + k, cur)
        return cur

    carry = jax.lax.fori_loop(0, n_chunks, chunk, carry)
    for i in range(n_chunks * UNROLL_CHUNK, count):
        carry = body(i, carry)
    return carry


def _sphere_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r):
    vx, vy, vz = ox - cx, oy - cy, oz - cz
    b = 2.0 * _dot(dx, dy, dz, vx, vy, vz)
    c = vx * vx + vy * vy + vz * vz - r * r
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t = jnp.where(t0 < 0.0, t1, t0)
    return t, (disc >= 0.0) & (t >= 0.0)


def _triangle_t(ox, oy, oz, dx, dy, dz, v0, e1, e2):
    """Moller-Trumbore with precomputed edges e1 = v1-v0, e2 = v2-v0."""
    qx = dy * e2[2] - dz * e2[1]
    qy = dz * e2[0] - dx * e2[2]
    qz = dx * e2[1] - dy * e2[0]
    det = e1[0] * qx + e1[1] * qy + e1[2] * qz
    degen = jnp.abs(det) <= 1e-7
    inv = 1.0 / jnp.where(degen, 1.0, det)
    sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
    rx = sy * e1[2] - sz * e1[1]
    ry = sz * e1[0] - sx * e1[2]
    rz = sx * e1[1] - sy * e1[0]
    t = (e2[0] * rx + e2[1] * ry + e2[2] * rz) * inv
    w1 = (sx * qx + sy * qy + sz * qz) * inv
    w2 = (dx * rx + dy * ry + dz * rz) * inv
    w0 = 1.0 - w1 - w2
    valid = (~degen) & (t > 0.0) & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    return t, w1, w2, valid


def _scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                    u_branch, u_a, u_b, m, feat=(True, True, True)):
    """The branch-cascade scatter step (CudaTracer.cu:208-318) on per-lane
    vectors; ``ops/bsdf.scatter`` is the jnp form it mirrors.

    ``m`` is the 20-tuple of per-lane material values in pack_scene column
    order. Returns (new origin, new direction, weight, alive, branch masks
    take_diff/take_spec, ct mask).

    ``feat = (has_ct, has_finite_exp, has_refr)`` statically skips sampler
    blocks no material in the scene can reach: the Beckmann microfacet draw
    when nothing carries the CT flags, the Phong pow when every specular is
    a delta mirror, the refraction math when nothing refracts. Output is
    bitwise identical — the skipped branches' select masks are all-false
    by construction."""
    (m_dr, m_dg, m_db, m_sr, m_sg, m_sb, _m_ar, _m_ag, _m_ab,
     _m_er, _m_eg, _m_eb, m_exp, m_ior, m_pd, m_ps, m_prf, m_rough,
     m_pure, m_ct) = m
    has_ct, has_fin_exp, has_refr = feat
    two_pi = 2.0 * math.pi

    outside = cos_i > 0.0
    n1 = jnp.where(outside, 1.0, m_ior)
    n2 = jnp.where(outside, m_ior, 1.0)
    cos_pos = jnp.abs(cos_i)
    n_ratio = n1 / jnp.maximum(n2, 1e-12)
    sin_t2 = n_ratio * n_ratio * (1.0 - cos_pos * cos_pos)
    tir = sin_t2 > 1.0
    cos_t = jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(1.0 - sin_t2, 0.0)))
    rs = ((n1 * cos_pos - n2 * cos_t)
          / jnp.maximum(n1 * cos_pos + n2 * cos_t, 1e-12))
    rp = ((n2 * cos_pos - n1 * cos_t)
          / jnp.maximum(n2 * cos_pos + n1 * cos_t, 1e-12))
    fres = jnp.where(tir, 1.0, (rs * rs + rp * rp) * 0.5)

    pure = m_pure > 0.5
    ct = m_ct > 0.5
    p_diff = m_pd
    p_spec = m_ps * jnp.where(pure, 1.0, fres)
    p_refr = m_prf * (1.0 - fres)
    take_diff = u_branch < p_diff
    take_spec = (~take_diff) & (u_branch < p_diff + p_spec)
    take_refr = ((~take_diff) & (~take_spec)
                 & (u_branch < p_diff + p_spec + p_refr))

    theta = u_a * two_pi
    yy = jnp.sqrt(u_b)
    rr = jnp.sqrt(jnp.maximum(1.0 - yy * yy, 0.0))
    ddx, ddy, ddz = _rotate_y_to(nx, ny, nz, rr * jnp.cos(theta), yy,
                                 rr * jnp.sin(theta))

    # reference quirk: reflRay receives the cosine already flipped
    # positive (CudaTracer.cu:238/484), so inside hits reflect with
    # +|cosI| (unnormalized, outward-bent) — see ops/bsdf.py
    mrx = dx + 2.0 * cos_pos * nx
    mry = dy + 2.0 * cos_pos * ny
    mrz = dz + 2.0 * cos_pos * nz
    if has_fin_exp:
        fin = jnp.isfinite(m_exp)
        pexp = 1.0 / (jnp.where(fin, m_exp, 0.0) + 1.0)
        s_cl = jnp.clip(u_b, 1e-12, 1.0)
        ph_y = jnp.where(fin, jnp.exp(pexp * jnp.log(s_cl)), 1.0)
        ph_r = jnp.sqrt(jnp.maximum(1.0 - ph_y * ph_y, 0.0))
        phx, phy_, phz = _rotate_y_to(mrx, mry, mrz, ph_r * jnp.cos(theta),
                                      ph_y, ph_r * jnp.sin(theta))
        gsx = jnp.where(fin, phx, mrx)
        gsy = jnp.where(fin, phy_, mry)
        gsz = jnp.where(fin, phz, mrz)
    else:
        gsx, gsy, gsz = mrx, mry, mrz

    if has_ct:
        u_ac = jnp.minimum(u_a, 1.0 - 1e-7)
        btan = -(m_rough * m_rough) * jnp.log1p(-u_ac)
        binv = jax.lax.rsqrt(1.0 + btan * btan)
        bphi = u_b * two_pi
        sb, cb2 = btan * binv, binv
        mx, my, mz = _rotate_y_to(nx, ny, nz, sb * jnp.cos(bphi), cb2,
                                  sb * jnp.sin(bphi))
        cos_m = jnp.abs(_dot(dx, dy, dz, mx, my, mz))
        ctx = dx + 2.0 * cos_m * mx
        cty = dy + 2.0 * cos_m * my
        ctz = dz + 2.0 * cos_m * mz
        hx, hy, hz = _normalize3(ctx - dx, cty - dy, ctz - dz, 1e-12)
        nh = jnp.abs(_dot(nx, ny, nz, hx, hy, hz))
        nl = jnp.abs(_dot(nx, ny, nz, ctx, cty, ctz))
        vh = jnp.maximum(jnp.abs(_dot(dx, dy, dz, hx, hy, hz)), 1e-12)
        nv = jnp.maximum(jnp.abs(cos_i), 1e-6)
        geom = jnp.minimum(jnp.minimum(1.0, 2.0 * nh * nl / vh),
                           2.0 * nh * nv / vh)
        ct_w = geom / nv

        spx = jnp.where(ct, ctx, gsx)
        spy = jnp.where(ct, cty, gsy)
        spz = jnp.where(ct, ctz, gsz)
        sp_ox = jnp.where(ct, px + mx * RAY_BUMP_EPSILON,
                          px + nx * RAY_BUMP_EPSILON)
        sp_oy = jnp.where(ct, py + my * RAY_BUMP_EPSILON,
                          py + ny * RAY_BUMP_EPSILON)
        sp_oz = jnp.where(ct, pz + mz * RAY_BUMP_EPSILON,
                          pz + nz * RAY_BUMP_EPSILON)
        spw = jnp.where(ct, ct_w, 1.0)
    else:
        spx, spy, spz = gsx, gsy, gsz
        sp_ox = px + nx * RAY_BUMP_EPSILON
        sp_oy = py + ny * RAY_BUMP_EPSILON
        sp_oz = pz + nz * RAY_BUMP_EPSILON
        spw = 1.0

    if has_refr:
        rfx0 = n_ratio * dx + (n_ratio * cos_pos - cos_t) * nx
        rfy0 = n_ratio * dy + (n_ratio * cos_pos - cos_t) * ny
        rfz0 = n_ratio * dz + (n_ratio * cos_pos - cos_t) * nz
        rfx, rfy, rfz = _normalize3(rfx0, rfy0, rfz0, 1e-12)
    else:
        rfx, rfy, rfz = mrx, mry, mrz  # unreachable (take_refr all-false)

    new_dx = jnp.where(take_diff, ddx, jnp.where(take_spec, spx, rfx))
    new_dy = jnp.where(take_diff, ddy, jnp.where(take_spec, spy, rfy))
    new_dz = jnp.where(take_diff, ddz, jnp.where(take_spec, spz, rfz))
    new_ox = jnp.where(take_diff, px + nx * RAY_BUMP_EPSILON,
                       jnp.where(take_spec, sp_ox,
                                 px + rfx * RAY_BUMP_EPSILON))
    new_oy = jnp.where(take_diff, py + ny * RAY_BUMP_EPSILON,
                       jnp.where(take_spec, sp_oy,
                                 py + rfy * RAY_BUMP_EPSILON))
    new_oz = jnp.where(take_diff, pz + nz * RAY_BUMP_EPSILON,
                       jnp.where(take_spec, sp_oz,
                                 pz + rfz * RAY_BUMP_EPSILON))
    wr = jnp.where(take_diff, m_dr,
                   jnp.where(take_spec, m_sr * spw,
                             jnp.where(take_refr, 1.0, 0.0)))
    wg = jnp.where(take_diff, m_dg,
                   jnp.where(take_spec, m_sg * spw,
                             jnp.where(take_refr, 1.0, 0.0)))
    wb = jnp.where(take_diff, m_db,
                   jnp.where(take_spec, m_sb * spw,
                             jnp.where(take_refr, 1.0, 0.0)))
    alive = take_diff | take_spec | (take_refr & (~tir))

    return (new_ox, new_oy, new_oz, new_dx, new_dy, new_dz, wr, wg, wb,
            alive, take_diff, take_spec, ct)


# ---------------------------------------------------------------------------
# Physical (unbiased MIS) estimator math — per-lane ports of
# ops/shading.shade_physical + the integrator's per-lobe MIS bookkeeping
# (render/integrator.py bounce, physical=True). The estimator replaces the
# reference's quirky NEE (CudaTracer.cu:345-455) with correct-measure
# uniform-area light sampling + power-heuristic MIS.
# ---------------------------------------------------------------------------

def _phong_pdf_p(ax, ay, az, exponent, wx, wy, wz):
    """ops/sampling.phong_pdf: (n+1)/(2pi) cos^n about the unit lobe axis;
    infinite exponent = delta (density 0)."""
    cos_a = _dot(wx, wy, wz, ax, ay, az)
    finite = jnp.isfinite(exponent)
    e = jnp.where(finite, exponent, 1.0)
    safe = jnp.maximum(cos_a, 1e-12)
    pdf = (e + 1.0) / (2.0 * math.pi) * jnp.exp(e * jnp.log(safe))
    return jnp.where(finite & (cos_a > 0.0), pdf, 0.0)


def _beckmann_pdf_p(ax, ay, az, roughness, mx, my, mz):
    """ops/sampling.beckmann_pdf (the sampler's exact density, NOT the
    textbook NDF — see that docstring)."""
    cos_t = _dot(mx, my, mz, ax, ay, az)
    r2 = roughness * roughness
    valid = (cos_t > 0.0) & (roughness > 0.0)
    cos_safe = jnp.maximum(cos_t, 1e-12)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 1e-12))
    tan_t = sin_t / cos_safe
    r2_safe = jnp.maximum(r2, 1e-12)
    pdf = (jnp.exp(-tan_t / r2_safe) * (1.0 + tan_t * tan_t)
           / (2.0 * math.pi * r2_safe * sin_t))
    return jnp.where(valid, pdf, 0.0)


def _lobe_axis(tx, ty, tz):
    """ops/sampling.phong_lobe_axis: the image of +Y under
    rotate_y_to(target) — the true unit lobe axis even for unnormalized
    targets (raw surfel normals / quirk mirror directions)."""
    zero = jnp.zeros_like(tx)
    return _rotate_y_to(tx, ty, tz, zero, jnp.ones_like(tx), zero)


def _physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, m):
    """Per-surfel lobe description the physical NEE and the continuation
    density share (integrator.py bounce: GlossLobe / CTLobe construction).
    Returns a dict of per-lane values."""
    (m_dr, m_dg, m_db, m_sr, m_sg, m_sb, _a, _b, _c, _d, _e, _f,
     m_exp, m_ior, m_pd, m_ps, _m_prf, m_rough, m_pure, m_ct) = m
    nux, nuy, nuz = _normalize3(nx, ny, nz, 1e-12)
    outside = cos_i > 0.0
    n1 = jnp.where(outside, 1.0, m_ior)
    n2 = jnp.where(outside, m_ior, 1.0)
    cos_pos = jnp.abs(cos_i)
    n_ratio = n1 / jnp.maximum(n2, 1e-12)
    sin_t2 = n_ratio * n_ratio * (1.0 - cos_pos * cos_pos)
    cos_t = jnp.sqrt(jnp.where(sin_t2 < 1.0,
                               jnp.maximum(1.0 - sin_t2, 0.0), 1.0))
    rs = ((n1 * cos_pos - n2 * cos_t)
          / jnp.maximum(n1 * cos_pos + n2 * cos_t, 1e-12))
    rp = ((n2 * cos_pos - n1 * cos_t)
          / jnp.maximum(n2 * cos_pos + n1 * cos_t, 1e-12))
    fres = jnp.where(sin_t2 > 1.0, 1.0, (rs * rs + rp * rp) * 0.5)
    pure = m_pure > 0.5
    ct = m_ct > 0.5
    p_spec = m_ps * jnp.where(pure, 1.0, fres)
    # Phong glossy lobe about the quirk mirror direction (raw normal)
    mrx = dx + 2.0 * cos_pos * nx
    mry = dy + 2.0 * cos_pos * ny
    mrz = dz + 2.0 * cos_pos * nz
    gax, gay, gaz = _lobe_axis(mrx, mry, mrz)
    prob_g = jnp.where(ct, 0.0, p_spec)
    # Cook-Torrance/Beckmann lobe about the raw surfel normal
    cax, cay, caz = _lobe_axis(nx, ny, nz)
    prob_ct = jnp.where(ct & (m_rough > 0.0), p_spec, 0.0)
    nv = jnp.maximum(jnp.abs(cos_i), 1e-6)
    return dict(n_unit=(nux, nuy, nuz), gloss_axis=(gax, gay, gaz),
                prob_g=prob_g, ct_axis=(cax, cay, caz), prob_ct=prob_ct,
                nv=nv, spec=(m_sr, m_sg, m_sb), diffuse=(m_dr, m_dg, m_db),
                diff_avg=m_pd, exponent=m_exp, roughness=m_rough)


def _lobe_terms(lb, dx, dy, dz, nx, ny, nz, wx, wy, wz,
                feat=(True, True, True)):
    """(f_cos scalars per lobe, densities) toward direction w — shade_
    physical's lobe_terms + ct_lobe_terms. Returns (s_d, p_g, s_ct, p_ct,
    cos_s): contribution = diffuse*s_d + spec*(p_g + s_ct) (weights-as-
    albedos convention). ``feat`` statically zeroes lobes no material
    carries (the masks are all-false anyway — bitwise identical)."""
    nux, nuy, nuz = lb["n_unit"]
    cos_s = jnp.maximum(0.0, _dot(nux, nuy, nuz, wx, wy, wz))
    s_d = lb["diff_avg"] * INV_PI * cos_s
    if feat[1]:
        gax, gay, gaz = lb["gloss_axis"]
        p_g = lb["prob_g"] * _phong_pdf_p(gax, gay, gaz, lb["exponent"],
                                          wx, wy, wz)
    else:
        p_g = jnp.zeros_like(cos_s)
    if feat[0]:
        # Cook-Torrance reflection branch: h = normalize(w - d)
        hx, hy, hz = _normalize3(wx - dx, wy - dy, wz - dz, 1e-12)
        dh = jnp.maximum(jnp.abs(_dot(dx, dy, dz, hx, hy, hz)), 1e-12)
        cax, cay, caz = lb["ct_axis"]
        p_dir = _beckmann_pdf_p(cax, cay, caz, lb["roughness"],
                                hx, hy, hz) / (4.0 * dh)
        p_ct = lb["prob_ct"] * p_dir
        nh = jnp.abs(_dot(nx, ny, nz, hx, hy, hz))
        nl = jnp.abs(_dot(nx, ny, nz, wx, wy, wz))
        geom = jnp.minimum(jnp.minimum(1.0, 2.0 * nh * nl / dh),
                           2.0 * nh * lb["nv"] / dh)
        s_ct = geom / lb["nv"] * p_ct
    else:
        p_ct = jnp.zeros_like(cos_s)
        s_ct = jnp.zeros_like(cos_s)
    return s_d, p_g, s_ct, p_ct, cos_s


def _al_light_geom(a):
    """Per-light geometry scalars from one area-light row (23 values):
    triangle areas, unit geometric normals, total area — matching
    ops/shading._tri_area_normal exactly."""
    def tri_geom(v0, v1, v2):
        e1 = (v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2])
        e2 = (v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2])
        rx = e1[1] * e2[2] - e1[2] * e2[1]
        ry = e1[2] * e2[0] - e1[0] * e2[2]
        rz = e1[0] * e2[1] - e1[1] * e2[0]
        n2 = rx * rx + ry * ry + rz * rz
        area = 0.5 * jnp.sqrt(jnp.maximum(n2, 1e-12))
        inv = jax.lax.rsqrt(jnp.maximum(n2, 1e-12))
        return area, (rx * inv, ry * inv, rz * inv)
    v = [(a[3 * k], a[3 * k + 1], a[3 * k + 2]) for k in range(6)]
    area0, n0 = tri_geom(v[0], v[1], v[2])
    area1, n1 = tri_geom(v[3], v[4], v[5])
    return dict(v=v, area0=area0, area1=area1, total=area0 + area1,
                n0=n0, n1=n1)


def _al_sample_point(geom, u1, u2, upick):
    """Uniform-area point on the light (area-proportional triangle pick,
    sqrt-reparameterized barycentrics — shading.area_light_sample_uniform).
    Returns (point, unit geometric normal of the picked triangle)."""
    first = upick < (geom["area0"] / geom["total"])
    su = jnp.sqrt(jnp.clip(u1, 0.0, 1.0))
    w0 = 1.0 - su
    w1 = su * (1.0 - u2)
    w2 = su * u2
    v = geom["v"]
    lx = jnp.where(first, v[0][0] * w0 + v[1][0] * w1 + v[2][0] * w2,
                   v[3][0] * w0 + v[4][0] * w1 + v[5][0] * w2)
    ly = jnp.where(first, v[0][1] * w0 + v[1][1] * w1 + v[2][1] * w2,
                   v[3][1] * w0 + v[4][1] * w1 + v[5][1] * w2)
    lz = jnp.where(first, v[0][2] * w0 + v[1][2] * w1 + v[2][2] * w2,
                   v[3][2] * w0 + v[4][2] * w1 + v[5][2] * w2)
    n0, n1 = geom["n0"], geom["n1"]
    nlx = jnp.where(first, n0[0] + jnp.zeros_like(lx), n1[0])
    nly = jnp.where(first, n0[1] + jnp.zeros_like(lx), n1[1])
    nlz = jnp.where(first, n0[2] + jnp.zeros_like(lx), n1[2])
    return (lx, ly, lz), (nlx, nly, nlz)


def _physical_prev_pdf(lb, dx, dy, dz, ndx, ndy, ndz,
                       take_diff, gloss_br, ct_br,
                       feat=(True, True, True)):
    """Effective solid-angle density of the scatter continuation — the
    quantity MIS weighs emission hits against (integrator.py bounce,
    prev_pdf update). ``feat`` skips lobes no material carries."""
    nux, nuy, nuz = lb["n_unit"]
    cos_new = jnp.maximum(0.0, _dot(ndx, ndy, ndz, nux, nuy, nuz))
    pdf_diff = lb["diff_avg"] * cos_new * INV_PI
    if feat[1]:
        gax, gay, gaz = lb["gloss_axis"]
        pdf_gloss = lb["prob_g"] * _phong_pdf_p(gax, gay, gaz,
                                                lb["exponent"],
                                                ndx, ndy, ndz)
    else:
        pdf_gloss = 0.0
    if feat[0]:
        hx, hy, hz = _normalize3(ndx - dx, ndy - dy, ndz - dz, 1e-12)
        dm = _dot(dx, dy, dz, hx, hy, hz)
        cax, cay, caz = lb["ct_axis"]
        pdf_ct = jnp.where(
            dm < 0.0,
            lb["prob_ct"] * _beckmann_pdf_p(cax, cay, caz, lb["roughness"],
                                            hx, hy, hz)
            / (4.0 * jnp.maximum(jnp.abs(dm), 1e-12)),
            0.0)
    else:
        pdf_ct = 0.0
    return jnp.where(take_diff, pdf_diff,
                     jnp.where(gloss_br, pdf_gloss,
                               jnp.where(ct_br, pdf_ct, 0.0)))


def _physical_direct(num_spheres, num_pls, num_als,
                     px, py, pz, nx, ny, nz, dx, dy, dz, t_w, pp,
                     lb, mf, pl_vals, le_vals, geoms, al_draws,
                     occ_pl, occ_al, prim_f, al_t0f,
                     feat=(True, True, True)):
    """Physical-mode direct radiance at the hit — the emission-MIS weight
    plus per-lobe NEE over point and area lights. The occlusion booleans
    (``occ_pl``/``occ_al``) and the area-light draws arrive as inputs.

    ``t_w`` is the hit distance (1.0 on miss), ``pp`` the carried
    prev_pdf, ``lb`` the ``_physical_lobes`` of (d, n, mf), ``mf`` the 20
    material values, ``pl_vals`` 6 scalars per point light, ``le_vals`` 3
    emission scalars per area light, ``geoms`` the ``_al_light_geom``
    dicts, ``al_draws`` (u1, u2, upick) per light, ``al_t0f`` each
    light's first-triangle index as an f32 scalar. Returns
    (dir_r, dir_g, dir_b) — NOT masked by hit/activity (callers mask)."""
    zero = jnp.zeros_like(px)
    cos_i = -_dot(dx, dy, dz, nx, ny, nz)
    inside = cos_i <= 0.0

    # emission MIS weight for BSDF-sampled hits on a light
    # (integrator.py bounce: complementary to the NEE weight)
    a_hit = zero
    cgx = zero
    cgy = zero
    cgz = zero
    for i in range(num_als):
        g = geoms[i]
        t0f = al_t0f[i] + float(num_spheres)
        is0 = prim_f == t0f
        is1 = prim_f == t0f + 1.0
        a_hit = jnp.where(is0 | is1, g["total"], a_hit)
        cgx = jnp.where(is0, g["n0"][0], jnp.where(is1, g["n1"][0], cgx))
        cgy = jnp.where(is0, g["n0"][1], jnp.where(is1, g["n1"][1], cgy))
        cgz = jnp.where(is0, g["n0"][2], jnp.where(is1, g["n1"][2], cgz))
    cos_l_hit = jnp.abs(_dot(dx, dy, dz, cgx, cgy, cgz))
    p_l_hit = (t_w * t_w) / jnp.maximum(a_hit * cos_l_hit, 1e-12)
    w_emit = jnp.where(
        (pp > 0.0) & (a_hit > 0.0),
        (pp * pp) / jnp.maximum(pp * pp + p_l_hit * p_l_hit, 1e-20),
        1.0)

    dir_r = mf[9] * w_emit
    dir_g = mf[10] * w_emit
    dir_b = mf[11] * w_emit
    m_dr_, m_dg_, m_db_ = lb["diffuse"]
    m_sr_, m_sg_, m_sb_ = lb["spec"]

    for i in range(num_pls):
        lx, ly, lz = pl_vals[6 * i], pl_vals[6 * i + 1], pl_vals[6 * i + 2]
        offx, offy, offz = lx - px, ly - py, lz - pz
        d2 = jnp.maximum(offx * offx + offy * offy + offz * offz, 1e-12)
        inv_d = 1.0 / jnp.sqrt(d2)
        wx, wy, wz = offx * inv_d, offy * inv_d, offz * inv_d
        s_d, p_g, s_ct, _p_ct, _cs = _lobe_terms(
            lb, dx, dy, dz, nx, ny, nz, wx, wy, wz, feat=feat)
        vis = jnp.where(occ_pl[i], 0.0, 1.0)
        irr = vis / (4.0 * math.pi * d2)
        cr = pl_vals[6 * i + 3] * irr * (m_dr_ * s_d + m_sr_ * (p_g + s_ct))
        cg = pl_vals[6 * i + 4] * irr * (m_dg_ * s_d + m_sg_ * (p_g + s_ct))
        cb = pl_vals[6 * i + 5] * irr * (m_db_ * s_d + m_sb_ * (p_g + s_ct))
        dir_r += jnp.where(inside, 0.0, cr)
        dir_g += jnp.where(inside, 0.0, cg)
        dir_b += jnp.where(inside, 0.0, cb)

    for i in range(num_als):
        g = geoms[i]
        (lx, ly, lz), (nlx, nly, nlz) = _al_sample_point(g, *al_draws[i])
        offx, offy, offz = lx - px, ly - py, lz - pz
        d2 = jnp.maximum(offx * offx + offy * offy + offz * offz, 1e-12)
        inv_d = 1.0 / jnp.sqrt(d2)
        wx, wy, wz = offx * inv_d, offy * inv_d, offz * inv_d
        s_d, p_g, s_ct, p_ct, cos_s = _lobe_terms(
            lb, dx, dy, dz, nx, ny, nz, wx, wy, wz, feat=feat)
        cos_l = jnp.abs(_dot(nlx, nly, nlz, wx, wy, wz))
        geo = jnp.where(occ_al[i], 0.0, cos_l * g["total"] / d2)
        p_l = d2 / jnp.maximum(g["total"] * cos_l, 1e-12)
        p_b = lb["diff_avg"] * cos_s * INV_PI
        w_d = (p_l * p_l) / jnp.maximum(p_l * p_l + p_b * p_b, 1e-12)
        w_g = (p_l * p_l) / jnp.maximum(p_l * p_l + p_g * p_g, 1e-12)
        w_ct = (p_l * p_l) / jnp.maximum(p_l * p_l + p_ct * p_ct, 1e-12)
        ler, leg, leb = le_vals[3 * i], le_vals[3 * i + 1], le_vals[3 * i + 2]
        cr = ler * (m_dr_ * s_d * geo * w_d
                    + m_sr_ * (p_g * geo * w_g + s_ct * geo * w_ct))
        cg = leg * (m_dg_ * s_d * geo * w_d
                    + m_sg_ * (p_g * geo * w_g + s_ct * geo * w_ct))
        cb = leb * (m_db_ * s_d * geo * w_d
                    + m_sb_ * (p_g * geo * w_g + s_ct * geo * w_ct))
        dir_r += jnp.where(inside, 0.0, cr)
        dir_g += jnp.where(inside, 0.0, cg)
        dir_b += jnp.where(inside, 0.0, cb)

    return dir_r, dir_g, dir_b


def _make_sweep_fns(counts, shape, sph_ref, tri_ref, track_index=False):
    """The two scene sweeps every bounce runs: every primitive tested for
    every lane, one scalar table row per primitive.

    ``track_index=True`` makes ``intersect_sweep`` also return the winning
    primitive index as f32 (spheres ``0..S``, triangles ``S..S+T``, miss
    ``-1``) — the physical estimator and the texture block key on it."""
    num_spheres, num_tris = counts[0], counts[1]

    def zero():
        return jnp.zeros(shape, jnp.float32)

    def sph_test(i, ox, oy, oz, dx, dy, dz):
        cx, cy, cz = sph_ref[i, 0], sph_ref[i, 1], sph_ref[i, 2]
        t, valid = _sphere_t(ox, oy, oz, dx, dy, dz, cx, cy, cz,
                             sph_ref[i, 3])
        return t, valid, (cx, cy, cz)

    def tri_test(i, ox, oy, oz, dx, dy, dz):
        return _triangle_t(
            ox, oy, oz, dx, dy, dz,
            (tri_ref[i, 0], tri_ref[i, 1], tri_ref[i, 2]),
            (tri_ref[i, 3], tri_ref[i, 4], tri_ref[i, 5]),
            (tri_ref[i, 6], tri_ref[i, 7], tri_ref[i, 8]))

    def idx_f(i, offset):
        return jnp.asarray(i, jnp.int32).astype(jnp.float32) + float(offset)

    def sph_nearest(i, carry, ox, oy, oz, dx, dy, dz):
        best_t, nx, ny, nz, mat_f = carry[:5]
        t, valid, (cx, cy, cz) = sph_test(i, ox, oy, oz, dx, dy, dz)
        closer = valid & (t <= best_t)
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        snx, sny, snz = _normalize3(px - cx, py - cy, pz - cz)
        out = (jnp.where(closer, t, best_t),
               jnp.where(closer, snx, nx),
               jnp.where(closer, sny, ny),
               jnp.where(closer, snz, nz),
               jnp.where(closer, sph_ref[i, 4], mat_f))
        if track_index:
            out = out + (jnp.where(closer, idx_f(i, 0), carry[5]),)
        return out

    def tri_nearest(i, carry, ox, oy, oz, dx, dy, dz):
        best_t, nx, ny, nz, mat_f = carry[:5]
        t, w1, w2, valid = tri_test(i, ox, oy, oz, dx, dy, dz)
        closer = valid & (t <= best_t)
        # barycentric normal interpolation, unnormalized — exactly
        # Primitives.h:71-73 (and the jnp engine's surfel_at)
        w0 = 1.0 - w1 - w2
        tnx = tri_ref[i, 9] * w0 + tri_ref[i, 12] * w1 + tri_ref[i, 15] * w2
        tny = tri_ref[i, 10] * w0 + tri_ref[i, 13] * w1 + tri_ref[i, 16] * w2
        tnz = tri_ref[i, 11] * w0 + tri_ref[i, 14] * w1 + tri_ref[i, 17] * w2
        out = (jnp.where(closer, t, best_t),
               jnp.where(closer, tnx, nx),
               jnp.where(closer, tny, ny),
               jnp.where(closer, tnz, nz),
               jnp.where(closer, tri_ref[i, 18], mat_f))
        if track_index:
            out = out + (jnp.where(closer, idx_f(i, num_spheres),
                                   carry[5]),)
        return out

    def intersect_sweep(ox, oy, oz, dx, dy, dz):
        carry = (jnp.full(shape, jnp.inf, jnp.float32), zero(), zero(),
                 zero(), zero())
        if track_index:
            carry = carry + (jnp.full(shape, -1.0, jnp.float32),)
        carry = _prim_loop(
            num_spheres,
            lambda i, c: sph_nearest(i, c, ox, oy, oz, dx, dy, dz), carry)
        return _prim_loop(
            num_tris,
            lambda i, c: tri_nearest(i, c, ox, oy, oz, dx, dy, dz), carry)

    def occlusion_sweep(sox, soy, soz, wx, wy, wz, max_d):
        def sph_body(i, occ):
            t, valid, _ = sph_test(i, sox, soy, soz, wx, wy, wz)
            return occ | (valid & (t <= max_d))

        def tri_body(i, occ):
            t, _, _, valid = tri_test(i, sox, soy, soz, wx, wy, wz)
            return occ | (valid & (t <= max_d))

        occ = _prim_loop(num_spheres, sph_body, jnp.zeros(shape, jnp.bool_))
        return _prim_loop(num_tris, tri_body, occ)

    return intersect_sweep, occlusion_sweep


def _texture_block(num_spheres, num_tris, shape, texmeta_ref, triuv_ref,
                   matids_ref, texel_ref, tri_ref, ox, oy, oz, dx, dy, dz,
                   prim_f, mat_i, nx, ny, nz, mf):
    """Color/normal mapping at the hit — ops/texture.py::apply_maps
    mirrored formula-for-formula (same polynomial atan2/asin, same
    normalize/eps conventions), so the textured kernel matches the jnp
    engine per pixel. Per-triangle UVs, per-texture metadata and texels
    are per-lane gathers from global memory.

    Returns (new diffuse r/g/b, new normal x/y/z)."""
    from ..texture import asinf, atan2f

    two_pi = 2.0 * math.pi
    n2 = nx * nx + ny * ny + nz * nz
    inv_nl = jax.lax.rsqrt(jnp.maximum(n2, 1e-20))
    nux, nuy, nuz = nx * inv_nl, ny * inv_nl, nz * inv_nl
    is_tri = prim_f > (num_spheres - 0.5)

    # ---- sphere UV + tangent (procedural; ops/texture.py::sphere_uv) ----
    u = 0.5 + atan2f(nuz, nux) / two_pi
    v = 0.5 + asinf(nuy) / math.pi
    st2 = nuz * nuz + nux * nux
    st_deg = st2 < 1e-12
    st_inv = jax.lax.rsqrt(jnp.maximum(st2, 1e-20))
    tgx = jnp.where(st_deg, 1.0, -nuz * st_inv)
    tgy = jnp.zeros(shape, jnp.float32)
    tgz = jnp.where(st_deg, 0.0, nux * st_inv)

    # ---- triangle UV + UV-aligned tangent (gather the hit triangle's
    # row, then one Moller-Trumbore barycentric recompute) ----
    if num_tris:
        ti = jnp.clip(prim_f.astype(jnp.int32) - num_spheres, 0,
                      num_tris - 1)
        v0x, v0y, v0z = tri_ref[ti, 0], tri_ref[ti, 1], tri_ref[ti, 2]
        e1x, e1y, e1z = tri_ref[ti, 3], tri_ref[ti, 4], tri_ref[ti, 5]
        e2x, e2y, e2z = tri_ref[ti, 6], tri_ref[ti, 7], tri_ref[ti, 8]
        u0u, u0v = triuv_ref[ti, 0], triuv_ref[ti, 1]
        u1u, u1v = triuv_ref[ti, 2], triuv_ref[ti, 3]
        u2u, u2v = triuv_ref[ti, 4], triuv_ref[ti, 5]
        _, w1, w2, _ = _triangle_t(ox, oy, oz, dx, dy, dz,
                                   (v0x, v0y, v0z), (e1x, e1y, e1z),
                                   (e2x, e2y, e2z))
        w0 = 1.0 - (w1 + w2)
        tu = u0u * w0 + u1u * w1 + u2u * w2
        tv = u0v * w0 + u1v * w1 + u2v * w2
        u = jnp.where(is_tri, tu, u)
        v = jnp.where(is_tri, tv, v)
        du1 = u1u - u0u
        dv1 = u1v - u0v
        du2 = u2u - u0u
        dv2 = u2v - u0v
        det = du1 * dv2 - du2 * dv1
        det_bad = jnp.abs(det) < 1e-12
        inv_det = jnp.where(det_bad, 0.0,
                            1.0 / jnp.where(det_bad, 1.0, det))
        ttx = (e1x * dv2 - e2x * dv1) * inv_det
        tty = (e1y * dv2 - e2y * dv1) * inv_det
        ttz = (e1z * dv2 - e2z * dv1) * inv_det
        tt2 = ttx * ttx + tty * tty + ttz * ttz
        degen = det_bad | (tt2 < 1e-16)
        e1inv = jax.lax.rsqrt(
            jnp.maximum(e1x * e1x + e1y * e1y + e1z * e1z, 1e-20))
        ttx = jnp.where(degen, e1x * e1inv, ttx)
        tty = jnp.where(degen, e1y * e1inv, tty)
        ttz = jnp.where(degen, e1z * e1inv, ttz)
        tgx = jnp.where(is_tri, ttx, tgx)
        tgy = jnp.where(is_tri, tty, tgy)
        tgz = jnp.where(is_tri, ttz, tgz)

    # ---- per-material map ids ----
    m_tex = matids_ref[mat_i, 0]
    m_nmap = matids_ref[mat_i, 1]
    num_tex = texmeta_ref.shape[0]

    # ---- bilinear atlas fetch (sample_bilinear's exact arithmetic) ----
    def sample(tid_f):
        k = jnp.clip(tid_f, 0.0, float(num_tex - 1)).astype(jnp.int32)
        base_i = texmeta_ref[k, 0].astype(jnp.int32)
        th = texmeta_ref[k, 1]
        tw = texmeta_ref[k, 2]
        uu = (u - jnp.floor(u)) * tw - 0.5
        vv = (1.0 - (v - jnp.floor(v))) * th - 0.5
        x0 = jnp.floor(uu)
        y0 = jnp.floor(vv)
        fx = uu - x0
        fy = vv - y0
        th_i = th.astype(jnp.int32)
        tw_i = tw.astype(jnp.int32)

        def texel(xi, yi):
            x = jnp.mod(xi.astype(jnp.int32), tw_i)
            y = jnp.mod(yi.astype(jnp.int32), th_i)
            idx = base_i + y * tw_i + x
            return [texel_ref[idx, c] for c in range(3)]

        c00 = texel(x0, y0)
        c10 = texel(x0 + 1, y0)
        c01 = texel(x0, y0 + 1)
        c11 = texel(x0 + 1, y0 + 1)
        w00 = (1 - fx) * (1 - fy)
        w10 = fx * (1 - fy)
        w01 = (1 - fx) * fy
        w11 = fx * fy
        return [c00[c] * w00 + c10[c] * w10 + c01[c] * w01 + c11[c] * w11
                for c in range(3)]

    ar, ag, ab = sample(m_tex)
    has_c = m_tex >= 0.0
    new_dr = mf[0] * jnp.where(has_c, ar, 1.0)
    new_dg = mf[1] * jnp.where(has_c, ag, 1.0)
    new_db = mf[2] * jnp.where(has_c, ab, 1.0)

    tr_, tg_, tb_ = sample(m_nmap)
    # tangent frame orthonormalized against the unit shading normal
    tdn = tgx * nux + tgy * nuy + tgz * nuz
    pox = tgx - nux * tdn
    poy = tgy - nuy * tdn
    poz = tgz - nuz * tdn
    po_inv = jax.lax.rsqrt(
        jnp.maximum(pox * pox + poy * poy + poz * poz, 1e-20))
    pox, poy, poz = pox * po_inv, poy * po_inv, poz * po_inv
    bx_ = nuy * poz - nuz * poy
    by_ = nuz * pox - nux * poz
    bz_ = nux * poy - nuy * pox
    tnx = tr_ * 2.0 - 1.0
    tny = tg_ * 2.0 - 1.0
    tnz = jnp.maximum(tb_ * 2.0 - 1.0, 1e-3)
    ppx = pox * tnx + bx_ * tny + nux * tnz
    ppy = poy * tnx + by_ * tny + nuy * tnz
    ppz = poz * tnx + bz_ * tny + nuz * tnz
    pp_inv = jax.lax.rsqrt(
        jnp.maximum(ppx * ppx + ppy * ppy + ppz * ppz, 1e-20))
    n_len = jnp.sqrt(jnp.maximum(n2, 1e-20))
    s_ = pp_inv * n_len
    has_n = m_nmap >= 0.0
    new_nx = jnp.where(has_n, ppx * s_, nx)
    new_ny = jnp.where(has_n, ppy * s_, ny)
    new_nz = jnp.where(has_n, ppz * s_, nz)
    return new_dr, new_dg, new_db, new_nx, new_ny, new_nz


def _make_render_kernel(counts, width, height, tile, physical=False,
                        textured=False, feat=(True, True, True)):
    num_spheres, num_tris, num_mats, num_pls, num_als = counts
    shape = (tile,)
    n_pixels = width * height

    def kernel(seed_ref, cam_ref, sph_ref, tri_ref, mat_ref, pl_ref, al_ref,
               bg_ref, *rest):
        if textured:
            texmeta_ref, triuv_ref, matids_ref, texel_ref = rest[:4]
        sx_ref, sy_ref, sz_ref = rest[-3:]
        intersect_sweep, occlusion_sweep = _make_sweep_fns(
            counts, shape, sph_ref, tri_ref,
            track_index=physical or textured)
        pid = pl.program_id(0)

        lane = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        # seed_ref[1] is a flat pixel offset: a device mesh gives each card
        # a disjoint pixel range while reusing one kernel build
        pixel = seed_ref[1] + pid * tile + lane
        in_image = (pixel < n_pixels) & (pixel >= 0)
        pxi = (pixel % width).astype(jnp.float32)
        pyi = (pixel // width).astype(jnp.float32)

        r00, r01, r02 = cam_ref[0], cam_ref[1], cam_ref[2]
        r10, r11, r12 = cam_ref[3], cam_ref[4], cam_ref[5]
        r20, r21, r22 = cam_ref[6], cam_ref[7], cam_ref[8]
        cam_x, cam_y, cam_z = cam_ref[9], cam_ref[10], cam_ref[11]
        tan_half, z_near = cam_ref[12], cam_ref[13]
        # cam_ref[14]: per-sample radiance clamp (<=0 disables). The
        # reference clamps every sample to [0,1] before accumulating
        # (writeToPixelsKernel, CudaTracer.cu:72) — that is its implicit
        # firefly suppression; expose it as a knob.
        clamp_v = cam_ref[14]

        # Counter-based uniforms (utils/rng.py): key (seed, pixel), counter
        # (global sample, pair). Identical streams to the jnp engine; every
        # lane draws from its OWN (sample, bounce) counters, so the
        # persistent regeneration loop below needs no RNG state at all.
        ppb = rng.pairs_per_bounce(num_als)

        def draw(sample_t, pair_t):
            return rng.uniform_pair(seed_ref[0], pixel, sample_t, pair_t)

        def bounce(state, s_glob, b_cur):
            if physical:
                (ox, oy, oz, dx, dy, dz, r0x, r0y, r0z, r1x, r1y, r1z,
                 active, prev_pdf) = state
            else:
                (ox, oy, oz, dx, dy, dz, r0x, r0y, r0z, r1x, r1y, r1z,
                 active) = state
            pair0 = 1 + b_cur * ppb  # rng.pair_base, per-lane bounce counter

            if physical or textured:
                (best_t, nx, ny, nz, mat_f,
                 prim_f) = intersect_sweep(ox, oy, oz, dx, dy, dz)
            else:
                best_t, nx, ny, nz, mat_f = intersect_sweep(ox, oy, oz,
                                                            dx, dy, dz)
            hit = best_t < jnp.inf
            t_safe = jnp.where(hit, best_t, 0.0)
            px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe

            # per-lane material row (miss lanes carry mat_f == 0.0 from the
            # sweep's init and read material 0, as the jnp engine does)
            mat_i = mat_f.astype(jnp.int32)
            mf = [mat_ref[mat_i, f] for f in range(M_COLS)]
            if textured:
                # color map modulates the diffuse albedo, normal map
                # perturbs the shading normal BEFORE cos_i / NEE / scatter,
                # exactly where the jnp engine applies them (integrator.py
                # bounce -> ops/texture.py apply_maps)
                (mf[0], mf[1], mf[2], nx, ny, nz) = _texture_block(
                    num_spheres, num_tris, shape, texmeta_ref, triuv_ref,
                    matids_ref, texel_ref, tri_ref, ox, oy, oz, dx, dy, dz,
                    prim_f, mat_i, nx, ny, nz, mf)
            (m_dr, m_dg, m_db, _m_sr, _m_sg, _m_sb, m_ar, m_ag, m_ab,
             m_er, m_eg, m_eb, _m_exp, _m_ior, m_pd, _m_ps, _m_prf, _m_rough,
             _m_pure, _m_ct) = mf

            cos_i = -_dot(dx, dy, dz, nx, ny, nz)
            inside = cos_i <= 0.0

            if physical:
                lb = _physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, mf)
                nux, nuy, nuz = lb["n_unit"]
                al_geoms = [_al_light_geom([al_ref[i, k] for k in range(23)])
                            for i in range(num_als)]
                al_draws = []
                for i in range(num_als):
                    u1, u2 = draw(s_glob, pair0 + 2 + 2 * i)
                    _u3, upick = draw(s_glob, pair0 + 3 + 2 * i)
                    al_draws.append((u1, u2, upick))

                def occ_of(lx, ly, lz):
                    offx, offy, offz = lx - px, ly - py, lz - pz
                    d2 = jnp.maximum(
                        offx * offx + offy * offy + offz * offz, 1e-12)
                    dist = jnp.sqrt(d2)
                    inv_d = 1.0 / dist
                    return occlusion_sweep(px + nux * RAY_BUMP_EPSILON,
                                           py + nuy * RAY_BUMP_EPSILON,
                                           pz + nuz * RAY_BUMP_EPSILON,
                                           offx * inv_d, offy * inv_d,
                                           offz * inv_d,
                                           dist - 2.0 * RAY_BUMP_EPSILON)

                zeros_p = jnp.zeros(shape, jnp.float32)
                occ_pl = [occ_of(pl_ref[i, 0] + zeros_p,
                                 pl_ref[i, 1] + zeros_p,
                                 pl_ref[i, 2] + zeros_p)
                          for i in range(num_pls)]
                occ_al = []
                for i in range(num_als):
                    (lx, ly, lz), _ = _al_sample_point(al_geoms[i],
                                                       *al_draws[i])
                    occ_al.append(occ_of(lx, ly, lz))
                pl_vals = [pl_ref[i, k] for i in range(num_pls)
                           for k in range(6)]
                le_vals = []
                for i in range(num_als):
                    lm = al_ref[i, 22].astype(jnp.int32)
                    le_vals += [mat_ref[lm, 9], mat_ref[lm, 10],
                                mat_ref[lm, 11]]
                t_w = jnp.where(hit, best_t, 1.0)
                dir_r, dir_g, dir_b = _physical_direct(
                    num_spheres, num_pls, num_als,
                    px, py, pz, nx, ny, nz, dx, dy, dz, t_w, prev_pdf,
                    lb, mf, pl_vals, le_vals, al_geoms, al_draws,
                    occ_pl, occ_al, prim_f,
                    [al_ref[i, 21] for i in range(num_als)], feat=feat)
            else:
                def light_contribution(lx, ly, lz, pwx, pwy, pwz):
                    offx, offy, offz = lx - px, ly - py, lz - pz
                    d2 = jnp.maximum(offx * offx + offy * offy + offz * offz, 1e-12)
                    dist = jnp.sqrt(d2)
                    inv_d = 1.0 / dist
                    wx, wy, wz = offx * inv_d, offy * inv_d, offz * inv_d
                    occ = occlusion_sweep(px + nx * RAY_BUMP_EPSILON,
                                          py + ny * RAY_BUMP_EPSILON,
                                          pz + nz * RAY_BUMP_EPSILON,
                                          wx, wy, wz,
                                          dist - 2.0 * RAY_BUMP_EPSILON)
                    cos_l = jnp.maximum(0.0, _dot(nx, ny, nz, wx, wy, wz))
                    scale = (jnp.where(occ, 0.0, cos_l) * m_pd * INV_PI
                             / (4.0 * math.pi) / d2)
                    return pwx * m_dr * scale, pwy * m_dg * scale, pwz * m_db * scale

                dir_r = m_er
                dir_g = m_eg
                dir_b = m_eb
                for i in range(num_pls):
                    cr, cg, cb = light_contribution(
                        pl_ref[i, 0] + jnp.zeros(shape, jnp.float32),
                        pl_ref[i, 1] + jnp.zeros(shape, jnp.float32),
                        pl_ref[i, 2] + jnp.zeros(shape, jnp.float32),
                        pl_ref[i, 3], pl_ref[i, 4], pl_ref[i, 5])
                    dir_r += jnp.where(inside, 0.0, cr)
                    dir_g += jnp.where(inside, 0.0, cg)
                    dir_b += jnp.where(inside, 0.0, cb)
                for i in range(num_als):
                    u1, u2 = draw(s_glob, pair0 + 2 + 2 * i)
                    u3, upick = draw(s_glob, pair0 + 3 + 2 * i)
                    inv_tot = 1.0 / jnp.maximum(u1 + u2 + u3, 1e-12)
                    w0, w1, w2 = u1 * inv_tot, u2 * inv_tot, u3 * inv_tot
                    first = upick > 0.5
                    a = [al_ref[i, k] for k in range(9)]
                    b = [al_ref[i, 9 + k] for k in range(9)]
                    lx = jnp.where(first, a[0] * w0 + a[3] * w1 + a[6] * w2,
                                   b[0] * w0 + b[3] * w1 + b[6] * w2)
                    ly = jnp.where(first, a[1] * w0 + a[4] * w1 + a[7] * w2,
                                   b[1] * w0 + b[4] * w1 + b[7] * w2)
                    lz = jnp.where(first, a[2] * w0 + a[5] * w1 + a[8] * w2,
                                   b[2] * w0 + b[5] * w1 + b[8] * w2)
                    cr, cg, cb = light_contribution(lx, ly, lz, al_ref[i, 18],
                                                    al_ref[i, 19], al_ref[i, 20])
                    dir_r += jnp.where(inside, 0.0, cr)
                    dir_g += jnp.where(inside, 0.0, cg)
                    dir_b += jnp.where(inside, 0.0, cb)

            act_hit = active & hit
            beer_mask = act_hit & inside
            r1x = jnp.where(beer_mask, r1x * jnp.exp(-t_safe * m_ar), r1x)
            r1y = jnp.where(beer_mask, r1y * jnp.exp(-t_safe * m_ag), r1y)
            r1z = jnp.where(beer_mask, r1z * jnp.exp(-t_safe * m_ab), r1z)

            r0x = r0x + jnp.where(act_hit, r1x * dir_r, 0.0)
            r0y = r0y + jnp.where(act_hit, r1y * dir_g, 0.0)
            r0z = r0z + jnp.where(act_hit, r1z * dir_b, 0.0)
            miss = active & (~hit)
            r0x += jnp.where(miss, bg_ref[0] * r1x, 0.0)
            r0y += jnp.where(miss, bg_ref[1] * r1y, 0.0)
            r0z += jnp.where(miss, bg_ref[2] * r1z, 0.0)

            # ---- scatter ---------------------------------------------------
            u_branch, u_a = draw(s_glob, pair0)
            u_b, _unused = draw(s_glob, pair0 + 1)
            (new_ox, new_oy, new_oz, new_dx, new_dy, new_dz, wr, wg, wb,
             alive, take_diff, take_spec, ct_m) = _scatter_sample(
                 dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                 u_branch, u_a, u_b, mf, feat=feat)
            if physical:
                pdf_new = _physical_prev_pdf(
                    lb, dx, dy, dz, new_dx, new_dy, new_dz,
                    take_diff, take_spec & (~ct_m), take_spec & ct_m,
                    feat=feat)
                prev_pdf = jnp.where(act_hit,
                                     jnp.where(~inside, pdf_new, 0.0),
                                     prev_pdf)

            ox = jnp.where(act_hit, new_ox, ox)
            oy = jnp.where(act_hit, new_oy, oy)
            oz = jnp.where(act_hit, new_oz, oz)
            dx = jnp.where(act_hit, new_dx, dx)
            dy = jnp.where(act_hit, new_dy, dy)
            dz = jnp.where(act_hit, new_dz, dz)
            r1x = jnp.where(act_hit, r1x * wr, r1x)
            r1y = jnp.where(act_hit, r1y * wg, r1y)
            r1z = jnp.where(act_hit, r1z * wb, r1z)

            out = (ox, oy, oz, dx, dy, dz, r0x, r0y, r0z, r1x, r1y, r1z,
                   act_hit & alive)
            return out + (prev_pdf,) if physical else out

        def eye_ray(s_glob):
            """Fresh jittered eye ray for every lane's pixel
            (computeEyeRay, CudaTracer.cu:321-343); draws the jitter pair."""
            ju, jv = draw(s_glob, rng.PAIR_EYE)
            jx = pxi + ju
            jy = pyi + jv
            s_fov = -2.0 * tan_half
            sx = (jx * (1.0 / width) - 0.5) * s_fov * z_near
            sy = ((jy * (1.0 / height) - 0.5) * s_fov * z_near
                  * (height / width))
            sz = z_near
            dx0 = r00 * sx + r01 * sy + r02 * sz
            dy0 = r10 * sx + r11 * sy + r12 * sz
            dz0 = r20 * sx + r21 * sy + r22 * sz
            return _normalize3(dx0, dy0, dz0)

        # -- persistent path regeneration --------------------------------
        # Each lane traces its pixel's spp samples back-to-back: the moment a
        # path terminates (absorbed, missed, or hit the bounce cap) the lane
        # immediately starts the next sample's eye ray. seed_ref[2] is the
        # global sample offset: progressive passes and sample-sharded meshes
        # continue the SAME per-pixel streams.
        samp0 = seed_ref[2]
        spp_s = seed_ref[3]
        max_b = seed_ref[4]
        zero = jnp.zeros(shape, jnp.float32)
        one = jnp.ones(shape, jnp.float32)

        dx, dy, dz = eye_ray(samp0 + jnp.zeros(shape, jnp.int32))
        state = (cam_x + zero, cam_y + zero, cam_z + zero, dx, dy, dz,
                 zero, zero, zero, one, one, one, in_image)
        if physical:
            state = state + (zero,)  # prev_pdf: camera rays carry 0
        # sample index per lane; out-of-image lanes start "done"
        s_idx = jnp.where(in_image, 0, spp_s)
        b_cnt = jnp.zeros(shape, jnp.int32)

        def cond(carry):
            return jnp.min(carry[0]) < spp_s

        def body(carry):
            s_idx, b_cnt, acc_x, acc_y, acc_z, st = carry
            was_active = st[12]
            st = bounce(st, samp0 + s_idx, b_cnt)
            now_active = st[12]
            b_cnt = jnp.where(was_active, b_cnt + 1, b_cnt)
            # path end: died this bounce, or still alive at the bounce cap
            # (capped paths keep their radiance, no background term —
            # matching the reference's maxIterations exit)
            ended = (was_active & (~now_active)) | (now_active & (b_cnt >= max_b))
            do_clamp = clamp_v > 0.0
            cx_ = jnp.where(do_clamp, jnp.minimum(st[6], clamp_v), st[6])
            cy_ = jnp.where(do_clamp, jnp.minimum(st[7], clamp_v), st[7])
            cz_ = jnp.where(do_clamp, jnp.minimum(st[8], clamp_v), st[8])
            acc_x = acc_x + jnp.where(ended, cx_, 0.0)
            acc_y = acc_y + jnp.where(ended, cy_, 0.0)
            acc_z = acc_z + jnp.where(ended, cz_, 0.0)
            s_idx = jnp.where(ended, s_idx + 1, s_idx)
            regen = ended & (s_idx < spp_s)

            ndx, ndy, ndz = eye_ray(samp0 + s_idx)
            sel = lambda a, b: jnp.where(regen, a, b)
            st_new = (sel(cam_x + zero, st[0]), sel(cam_y + zero, st[1]),
                      sel(cam_z + zero, st[2]),
                      sel(ndx, st[3]), sel(ndy, st[4]), sel(ndz, st[5]),
                      sel(zero, st[6]), sel(zero, st[7]), sel(zero, st[8]),
                      sel(one, st[9]), sel(one, st[10]), sel(one, st[11]),
                      regen | (st[12] & ~ended))
            if physical:
                st_new = st_new + (sel(zero, st[13]),)
            b_cnt = jnp.where(regen, 0, b_cnt)
            return s_idx, b_cnt, acc_x, acc_y, acc_z, st_new

        _, _, acc_x, acc_y, acc_z, _ = jax.lax.while_loop(
            cond, body, (s_idx, b_cnt, zero, zero, zero, state))

        sx_ref[...] = acc_x
        sy_ref[...] = acc_y
        sz_ref[...] = acc_z

    return kernel


def _render_block_sums(packed, cam_params, seed, width, height, spp,
                       max_bounces, pixel_offset, n_local, sample_offset,
                       sample_clamp=0.0, interpret=False, physical=False):
    """Radiance SUMS over spp for ``n_local`` pixels starting at flat index
    ``pixel_offset``; returns 3 vectors of ceil(n_local / tile) * tile
    entries. ``sample_offset`` selects the global sample range [offset,
    offset+spp) of each pixel's counter stream — progressive passes and
    sample-sharded meshes continue the exact streams a monolithic render
    would use. TILE / NUM_WARPS are read at trace time."""
    tile = TILE
    if tile & (tile - 1):
        raise ValueError(f"TILE={tile} must be a power of two")
    grid = (n_local + tile - 1) // tile

    rot, pos, tan_half, z_near = cam_params
    cam = jnp.concatenate([
        jnp.asarray(rot, jnp.float32).reshape(-1),
        jnp.asarray(pos, jnp.float32).reshape(-1),
        jnp.asarray(tan_half, jnp.float32).reshape(1),
        jnp.asarray(z_near, jnp.float32).reshape(1),
        jnp.asarray(sample_clamp, jnp.float32).reshape(1),
    ])
    seed_arr = jnp.stack([
        jnp.asarray(seed, jnp.int32).reshape(()),
        jnp.asarray(pixel_offset, jnp.int32).reshape(()),
        jnp.asarray(sample_offset, jnp.int32).reshape(()),
        jnp.asarray(spp, jnp.int32).reshape(()),
        jnp.asarray(max_bounces, jnp.int32).reshape(()),
    ])

    textured = packed.tex_count > 0
    kernel = _make_render_kernel(packed.counts, width, height, tile,
                                 physical=physical, textured=textured,
                                 feat=packed.feat)
    args = [seed_arr, cam, packed.spheres, packed.triangles,
            packed.materials, packed.point_lights, packed.area_lights,
            packed.background]
    if textured:
        args += [packed.tex_meta, packed.tex_triuv, packed.tex_matids,
                 packed.texels]
    out = pl.BlockSpec((tile,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * len(args),
        out_specs=[out] * 3,
        out_shape=[jax.ShapeDtypeStruct((grid * tile,), jnp.float32)] * 3,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="path_trace",
    )(*args)


@functools.partial(jax.jit, static_argnames=("width", "height", "interpret",
                                             "physical"))
def render_megakernel(packed: PackedScene, cam_params, seed,
                      width: int, height: int, spp,
                      max_bounces=15,
                      sample_clamp=0.0,
                      sample_offset=0,
                      interpret: bool = False,
                      physical: bool = False) -> jax.Array:
    """Full render in one kernel launch; returns mean radiance [H, W, 3].
    ``spp``, ``max_bounces``, ``sample_offset`` and ``sample_clamp`` are
    runtime scalars: one build serves every sampling configuration.
    ``sample_clamp > 0`` clamps every sample's radiance to that value before
    accumulation (the reference's per-frame [0,1] clamp; firefly control).
    ``interpret=True`` runs the kernel in Pallas interpret mode — slow, but
    it executes on the CPU, which is how the CPU tests cover this engine."""
    n = width * height
    sx, sy, sz = _render_block_sums(packed, cam_params, seed, width, height,
                                    spp, max_bounces, 0, n, sample_offset,
                                    sample_clamp, interpret=interpret,
                                    physical=physical)
    img = jnp.stack([sx[:n], sy[:n], sz[:n]], -1) / spp
    return img.reshape(height, width, 3)


def render_megakernel_sharded(packed: PackedScene, cam_params, seed,
                              width: int, height: int, spp: int, mesh,
                              max_bounces: int = 15,
                              physical: bool = False,
                              interpret: bool = False,
                              sample_offset=0) -> jax.Array:
    """Pixel-sharded kernel over a device mesh: each card renders a
    disjoint tile; no collectives in the forward pass (the DP layout of
    parallel/sharding.py, on the fused kernel). Streams are keyed on global
    pixel indices, so the sharded image is bitwise identical to 1-device."""
    from jax.sharding import PartitionSpec as P

    from ...parallel.mesh import PIXEL_AXIS

    n = width * height
    n_dev = mesh.shape[PIXEL_AXIS]
    tile = TILE
    # ceil-divide pixels across devices BEFORE rounding up to the tile:
    # flooring would under-cover the image whenever n % n_dev != 0
    per_dev = (((n + n_dev - 1) // n_dev + tile - 1) // tile) * tile
    if per_dev * (n_dev - 1) >= n:
        raise ValueError("too many devices for this image at this tile size")

    def tile_fn(packed, cam_params, seed):
        dev = jax.lax.axis_index(PIXEL_AXIS)
        sx, sy, sz = _render_block_sums(
            packed, cam_params, seed, width, height, spp, max_bounces,
            dev * per_dev, per_dev, sample_offset, physical=physical,
            interpret=interpret)
        return jnp.stack([sx, sy, sz], -1)

    # check_vma=False: pallas_call's out_shape structs carry no vma metadata,
    # which the vma checker (correctly) refuses; the body has no collectives,
    # so the unchecked mode is safe here.
    out = jax.shard_map(
        tile_fn, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(PIXEL_AXIS),
        check_vma=False,
    )(packed, cam_params, jnp.asarray(seed, jnp.int32))
    # Device d rendered global pixels [d*per_dev, (d+1)*per_dev), so `out`
    # is already in global pixel order; rows past n are dead padding lanes.
    return (out[:n] / spp).reshape(height, width, 3)


def render_fast2(scene, cam_params, width, height, spp, seed,
                 max_bounces: int = 15, sample_offset=0,
                 interpret: bool = False, physical: bool = False):
    """Convenience wrapper: pack + launch. ``physical=True`` runs the
    unbiased MIS estimator (same streams + formulas as the jnp engine's
    physical mode — per-pixel parity)."""
    return render_megakernel(pack_scene(scene), cam_params, seed, width,
                             height, spp, max_bounces=max_bounces,
                             sample_offset=sample_offset, interpret=interpret,
                             physical=physical)
