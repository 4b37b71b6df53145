"""Ray-primitive intersection over the wavefront.

Behavioral spec: ``CudaTracer/Primitives.h:26-83`` (Moller-Trumbore triangles
with barycentric-interpolated normals) and ``Primitives.h:108-175`` (sphere
quadratic with inside-hit handling). Where the reference runs one thread per
ray looping over primitives (``CudaTracer.cu:127-141``), here a ``lax.scan``
over the primitive axis carries a running (t, index) minimum across ``[N]``
component arrays — every step is an elementwise VPU op over all rays, no
``[N, P]`` buffer is materialized, and the whole sweep stays differentiable.

Tie semantics match the reference exactly: a later primitive at an equal
distance wins (``Primitives.h:52`` rejects only strictly farther hits), and
triangles are scanned after spheres (``CudaTracer.cu:127-141``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .vec import Vec3, full_like_vma, sqrt_clamped_grad, where as vwhere

TRI_DET_EPSILON = 1e-7  # Primitives.h:31

# Unrolling the sweep lets XLA fuse all primitive tests into one pass over
# the ray data. On the H100 a full unroll (64) made forward renders 1.7x
# (Cornell) to 5x (showcase) faster (PERF.md), but its autodiff compile
# time is unmeasured there, so the default keeps the compact scan; the fused
# kernel owns the fast forward path. Set >0 to experiment.
UNROLL_MAX_PRIMS = 0


def _sweep(step, carry, xs, count):
    return jax.lax.scan(step, carry, xs,
                        unroll=bool(count <= UNROLL_MAX_PRIMS))


class Hit(NamedTuple):
    t: jax.Array          # [N] distance (inf on miss)
    prim: jax.Array       # [N] int32: 0..S-1 spheres, S..S+T-1 triangles
    hit: jax.Array        # [N] bool


class Surfel(NamedTuple):
    point: Vec3           # [N]
    normal: Vec3          # [N] (triangle normals barycentric, NOT renormalized
                          #      — matching Primitives.h:71-73)
    mat: jax.Array        # [N] int32


def sphere_t(ro: Vec3, rd: Vec3, cx, cy, cz, radius):
    """Quadratic sphere test; returns (t, valid) for one sphere against all
    rays. Chooses the near root, falls back to the far root when inside
    (Primitives.h:108-175; accepted t may be 0 for the far root)."""
    v = ro - Vec3(cx, cy, cz)
    b = 2.0 * rd.dot(v)
    c = v.norm2() - radius * radius
    disc = b * b - 4.0 * c
    # sqrt of a guarded operand: miss lanes (disc < 0) must not inject
    # NaN into gradients through the unselected side of downstream wheres,
    # and grazing hits must not inject inf (see vec.sqrt_clamped_grad).
    sq = sqrt_clamped_grad(jnp.where(disc >= 0.0, disc, 1.0))
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t = jnp.where(t0 < 0.0, t1, t0)
    valid = (disc >= 0.0) & (t >= 0.0)
    return t, valid


def triangle_t(ro: Vec3, rd: Vec3, v0: Vec3, v1: Vec3, v2: Vec3):
    """Moller-Trumbore; returns (t, w1, w2, valid) for one triangle against
    all rays (Primitives.h:26-83). Edge hits (weight == 0) are accepted;
    t must be strictly positive."""
    e1 = v1 - v0
    e2 = v2 - v0
    q = rd.cross(e2)
    det = e1.dot(q)
    degenerate = jnp.abs(det) <= TRI_DET_EPSILON
    inv = 1.0 / jnp.where(degenerate, 1.0, det)
    s = ro - v0
    r = s.cross(e1)
    t = e2.dot(r) * inv
    w1 = s.dot(q) * inv
    w2 = rd.dot(r) * inv
    w0 = 1.0 - (w1 + w2)
    valid = (~degenerate) & (t > 0.0) & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    return t, w1, w2, valid


def _scan_min(carry, t, valid, idx):
    """Running nearest-hit update; later prims win ties (<=)."""
    best_t, best_i = carry
    t = jnp.where(valid, t, jnp.inf)
    closer = valid & (t <= best_t)
    return jnp.where(closer, t, best_t), jnp.where(closer, idx, best_i)


def nearest_hit(ro: Vec3, rd: Vec3, scene) -> Hit:
    """Nearest intersection of every ray with every primitive."""
    # full_like_vma: the carries must inherit the rays' varying manual axes
    # or the scan is ill-typed inside shard_map.
    best_t = full_like_vma(ro.x, jnp.inf)
    best_i = full_like_vma(ro.x, -1, dtype=jnp.int32)
    S = scene.num_spheres

    if S:
        def sph_step(carry, xs):
            cx, cy, cz, r, i = xs
            t, valid = sphere_t(ro, rd, cx, cy, cz, r)
            return _scan_min(carry, t, valid, i), None

        xs = (scene.sph_center.x, scene.sph_center.y, scene.sph_center.z,
              scene.sph_radius, jnp.arange(S, dtype=jnp.int32))
        (best_t, best_i), _ = _sweep(sph_step, (best_t, best_i), xs, S)

    if scene.num_triangles:
        def tri_step(carry, xs):
            v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z, i = xs
            t, _, _, valid = triangle_t(
                ro, rd, Vec3(v0x, v0y, v0z), Vec3(v1x, v1y, v1z), Vec3(v2x, v2y, v2z)
            )
            return _scan_min(carry, t, valid, i), None

        T = scene.num_triangles
        xs = (scene.tri_v0.x, scene.tri_v0.y, scene.tri_v0.z,
              scene.tri_v1.x, scene.tri_v1.y, scene.tri_v1.z,
              scene.tri_v2.x, scene.tri_v2.y, scene.tri_v2.z,
              jnp.arange(S, S + T, dtype=jnp.int32))
        (best_t, best_i), _ = _sweep(tri_step, (best_t, best_i), xs, T)

    return Hit(t=best_t, prim=best_i, hit=jnp.isfinite(best_t))


def surfel_at(ro: Vec3, rd: Vec3, hit: Hit, scene) -> Surfel:
    """Reconstruct the surface element for the winning primitive of each ray
    (recomputes the winner's barycentrics — cheaper than carrying [N, P]
    attributes through the sweep)."""
    S, T = scene.num_spheres, scene.num_triangles
    t = jnp.where(hit.hit, hit.t, 0.0)
    point = ro + rd * t
    is_tri = hit.prim >= S

    normal = Vec3.zeros(t.shape)
    mat = jnp.zeros(t.shape, jnp.int32)

    if S:
        si = jnp.clip(hit.prim, 0, S - 1)
        center = Vec3(scene.sph_center.x[si], scene.sph_center.y[si], scene.sph_center.z[si])
        sph_n = (point - center).normalize(eps=1e-20)
        normal = vwhere(~is_tri, sph_n, normal)
        mat = jnp.where(~is_tri, scene.sph_mat[si], mat)

    if T:
        ti = jnp.clip(hit.prim - S, 0, T - 1)
        v0 = Vec3(scene.tri_v0.x[ti], scene.tri_v0.y[ti], scene.tri_v0.z[ti])
        v1 = Vec3(scene.tri_v1.x[ti], scene.tri_v1.y[ti], scene.tri_v1.z[ti])
        v2 = Vec3(scene.tri_v2.x[ti], scene.tri_v2.y[ti], scene.tri_v2.z[ti])
        _, w1, w2, _ = triangle_t(ro, rd, v0, v1, v2)
        w0 = 1.0 - (w1 + w2)
        n0 = Vec3(scene.tri_n0.x[ti], scene.tri_n0.y[ti], scene.tri_n0.z[ti])
        n1 = Vec3(scene.tri_n1.x[ti], scene.tri_n1.y[ti], scene.tri_n1.z[ti])
        n2 = Vec3(scene.tri_n2.x[ti], scene.tri_n2.y[ti], scene.tri_n2.z[ti])
        tri_n = n0 * w0 + n1 * w1 + n2 * w2
        normal = vwhere(is_tri, tri_n, normal)
        mat = jnp.where(is_tri, scene.tri_mat[ti], mat)

    return Surfel(point=point, normal=normal, mat=mat)


def any_hit(ro: Vec3, rd: Vec3, max_dist, scene) -> jax.Array:
    """Occlusion query: does anything lie within ``max_dist`` along the ray?
    Matches the reference shadow test: reuses the same primitive tests with
    the hit-distance pre-clamped (``CudaTracer.cu:420-455``; a hit exactly at
    ``max_dist`` occludes, since only strictly-farther hits are rejected)."""
    occluded = full_like_vma(ro.x, False, dtype=bool)

    if scene.num_spheres:
        def sph_step(occ, xs):
            cx, cy, cz, r = xs
            t, valid = sphere_t(ro, rd, cx, cy, cz, r)
            return occ | (valid & (t <= max_dist)), None

        xs = (scene.sph_center.x, scene.sph_center.y, scene.sph_center.z, scene.sph_radius)
        occluded, _ = _sweep(sph_step, occluded, xs, scene.num_spheres)

    if scene.num_triangles:
        def tri_step(occ, xs):
            v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = xs
            t, _, _, valid = triangle_t(
                ro, rd, Vec3(v0x, v0y, v0z), Vec3(v1x, v1y, v1z), Vec3(v2x, v2y, v2z)
            )
            return occ | (valid & (t <= max_dist)), None

        xs = (scene.tri_v0.x, scene.tri_v0.y, scene.tri_v0.z,
              scene.tri_v1.x, scene.tri_v1.y, scene.tri_v1.z,
              scene.tri_v2.x, scene.tri_v2.y, scene.tri_v2.z)
        occluded, _ = _sweep(tri_step, occluded, xs, scene.num_triangles)

    return occluded
