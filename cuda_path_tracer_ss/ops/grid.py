"""Uniform-grid spatial acceleration, shared by both engines.

The reference sweeps every primitive per ray and leaves acceleration as its
own TODO (``CudaTracer/CudaTracer.cu:437`` "Use a better technique ... some
sort of hierarchical data structure"). This module is that structure, for
the jnp engine:

* **Build** (host, numpy): one uniform grid over the scene AABB with padded
  dense per-cell primitive lists — static shapes, so both engines can jit
  over it. Conservative AABB-overlap binning (false positives only).
* **jnp engine**: Amanatides–Woo 3D-DDA as a ``lax.scan`` over a static step
  bound. Each step gathers the current cell's padded lists and tests them
  vectorized over all rays — per-RAY work drops from O(prims) to
  O(cells-on-ray × occupancy). Gathers are differentiable, so material AND
  (interior) geometry gradients keep flowing; the cell lists themselves are
  discrete and rebuilt outside autodiff (document: rebuild the grid if you
  optimize geometry across cell boundaries).
The fused kernel has no grid traversal yet (per-ray traversal inside the
kernel is on ROADMAP.md); ``accel="grid"`` runs on the jnp engine. Its speed
against the linear sweep on the GPU is not measured yet
(``scripts/bench_grid_jnp.py`` measures it).

Hit semantics are identical to the linear sweep, including the reference's
tie rule (a later primitive index wins an exactly-equal ``t`` —
``Primitives.h:52`` rejects only strictly farther hits and triangles scan
after spheres). Because a grid visits primitives in cell order, the tie rule
is enforced explicitly: ``(t < best) | ((t == best) & (idx >= best_idx))``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .intersect import Hit, sphere_t, triangle_t
from .vec import Vec3, full_like_vma

# Build-time density: target ~LAMBDA cells per primitive along the scene
# volume (classic teapot-in-a-stadium heuristic).
LAMBDA = 3.0
MAX_RES = 16          # per-axis cap: <= 4096 cells keeps the lists small
PAD = 1e-3            # AABB slack so boundary prims land inside


class UniformGrid(NamedTuple):
    """Static-shape uniform grid. Array leaves; ``res`` / pad widths are
    baked into the array shapes so jit specializes on them."""
    origin: jax.Array      # [3] f32 grid min corner
    inv_cell: jax.Array    # [3] f32 1 / cell_size
    cell_size: jax.Array   # [3] f32
    res: Tuple[int, int, int]          # static
    sph_list: jax.Array    # [C, Ks] int32 sphere ids, -1 padded
    tri_list: jax.Array    # [C, Kt] int32 triangle ids, -1 padded
    sph_count: jax.Array   # [C] int32
    tri_count: jax.Array   # [C] int32

    @property
    def num_cells(self) -> int:
        return self.res[0] * self.res[1] * self.res[2]


def _as_np(v) -> np.ndarray:
    return np.asarray(jax.device_get(v))


jax.tree_util.register_pytree_node(
    UniformGrid,
    lambda g: ((g.origin, g.inv_cell, g.cell_size, g.sph_list, g.tri_list,
                g.sph_count, g.tri_count), g.res),
    lambda res, leaves: UniformGrid(leaves[0], leaves[1], leaves[2], res,
                                    leaves[3], leaves[4], leaves[5],
                                    leaves[6]),
)


def build_grid(scene, max_res: int = MAX_RES) -> UniformGrid:
    """Host-side grid build over the scene's primitive AABBs. Cheap (numpy,
    runs once at scene upload, like the reference's cudaMemcpy setup) and
    deliberately outside jit: the lists are discrete."""
    S, T = scene.num_spheres, scene.num_triangles
    boxes = []
    if S:
        c = np.stack([_as_np(scene.sph_center.x), _as_np(scene.sph_center.y),
                      _as_np(scene.sph_center.z)], -1)
        r = _as_np(scene.sph_radius)[:, None]
        boxes.append((c - r, c + r))
    if T:
        vs = [np.stack([_as_np(v.x), _as_np(v.y), _as_np(v.z)], -1)
              for v in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
        tv = np.stack(vs, 0)                      # [3, T, 3]
        boxes.append((tv.min(0), tv.max(0)))
    if not boxes:
        raise ValueError("empty scene has nothing to grid")

    lo = np.min([b[0].min(0) for b in boxes], 0) - PAD
    hi = np.max([b[1].max(0) for b in boxes], 0) + PAD
    extent = np.maximum(hi - lo, 1e-6)
    n_prims = S + T
    # cells-per-axis proportional to axis extent, ~LAMBDA * n_prims total
    k = (LAMBDA * n_prims / float(extent.prod())) ** (1.0 / 3.0)
    res = np.clip(np.floor(extent * k).astype(int), 1, max_res)
    rx, ry, rz = int(res[0]), int(res[1]), int(res[2])
    cell = extent / res

    def bin_boxes(bmin, bmax, centers=None, radii=None):
        """AABB binning; for spheres an exact box-sphere overlap test prunes
        the AABB's corner cells (max cell occupancy drives the padded list
        width, so pruning here is a direct speedup in both engines)."""
        i0 = np.clip(((bmin - lo) / cell).astype(int), 0, res - 1)
        i1 = np.clip(((bmax - lo) / cell).astype(int), 0, res - 1)
        per_cell = [[] for _ in range(rx * ry * rz)]
        for p in range(bmin.shape[0]):
            for iz in range(i0[p, 2], i1[p, 2] + 1):
                for iy in range(i0[p, 1], i1[p, 1] + 1):
                    for ix in range(i0[p, 0], i1[p, 0] + 1):
                        if centers is not None:
                            cmin = lo + cell * (ix, iy, iz)
                            q = np.clip(centers[p], cmin, cmin + cell)
                            if ((q - centers[p]) ** 2).sum() > radii[p] ** 2:
                                continue
                        per_cell[(iz * ry + iy) * rx + ix].append(p)
        return per_cell

    def pad_lists(per_cell):
        kmax = max(1, max(len(l) for l in per_cell))
        out = np.full((len(per_cell), kmax), -1, np.int32)
        cnt = np.zeros(len(per_cell), np.int32)
        for ci, l in enumerate(per_cell):
            out[ci, :len(l)] = l
            cnt[ci] = len(l)
        return out, cnt

    empty = [[] for _ in range(rx * ry * rz)]
    sph_cells = bin_boxes(*boxes[0], centers=c, radii=r[:, 0]) if S else empty
    tri_cells = bin_boxes(*boxes[-1]) if T else empty
    sph_list, sph_count = pad_lists(sph_cells)
    tri_list, tri_count = pad_lists(tri_cells)

    return UniformGrid(
        origin=jnp.asarray(lo, jnp.float32),
        inv_cell=jnp.asarray(1.0 / cell, jnp.float32),
        cell_size=jnp.asarray(cell, jnp.float32),
        res=(rx, ry, rz),
        sph_list=jnp.asarray(sph_list),
        tri_list=jnp.asarray(tri_list),
        sph_count=jnp.asarray(sph_count),
        tri_count=jnp.asarray(tri_count),
    )


def max_steps(grid: UniformGrid) -> int:
    """Static DDA step bound: the longest cell walk is the Manhattan
    diagonal."""
    return grid.res[0] + grid.res[1] + grid.res[2] + 1


def _tie_min(best_t, best_i, t, valid, idx):
    """Reference tie rule, order-independent: strictly closer wins; on an
    exact tie the LARGER primitive index wins (later-in-sweep semantics)."""
    t = jnp.where(valid, t, jnp.inf)
    closer = valid & ((t < best_t) | ((t == best_t) & (idx >= best_i)))
    return (jnp.where(closer, t, best_t),
            jnp.where(closer, idx, best_i))


def _dda_setup(grid: UniformGrid, ro: Vec3, rd: Vec3):
    """Entry state of the Amanatides–Woo walk for every ray."""
    res = jnp.asarray(grid.res, jnp.float32)
    # slab clip to the grid AABB
    t0 = full_like_vma(ro.x, 0.0)
    t1 = full_like_vma(ro.x, jnp.inf)
    axes_o = (ro.x, ro.y, ro.z)
    axes_d = (rd.x, rd.y, rd.z)
    for a in range(3):
        d = axes_d[a]
        o = axes_o[a]
        inv = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                              jnp.where(d < 0, -1e-20, 1e-20), d)
        ta = (grid.origin[a] - o) * inv
        tb = (grid.origin[a] + grid.cell_size[a] * res[a] - o) * inv
        t0 = jnp.maximum(t0, jnp.minimum(ta, tb))
        t1 = jnp.minimum(t1, jnp.maximum(ta, tb))
    inside = t0 <= t1
    t_enter = jnp.maximum(t0, 0.0)

    # first cell + per-axis stepping state
    cells, tmaxs, tdeltas, steps = [], [], [], []
    for a in range(3):
        d = axes_d[a]
        o = axes_o[a]
        p = o + d * (t_enter + 1e-5)
        ci = jnp.clip(jnp.floor((p - grid.origin[a]) * grid.inv_cell[a]),
                      0, grid.res[a] - 1).astype(jnp.int32)
        step = jnp.where(d > 0, 1, jnp.where(d < 0, -1, 0)).astype(jnp.int32)
        inv = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                              jnp.where(d < 0, -1e-20, 1e-20), d)
        next_bound = grid.origin[a] + (ci + jnp.maximum(step, 0)
                                       ).astype(jnp.float32) * grid.cell_size[a]
        tmax = jnp.where(step == 0, jnp.inf, (next_bound - o) * inv)
        tdelta = jnp.where(step == 0, jnp.inf,
                           grid.cell_size[a] * jnp.abs(inv))
        cells.append(ci)
        tmaxs.append(tmax)
        tdeltas.append(tdelta)
        steps.append(step)
    return inside, t_enter, t1, cells, tmaxs, tdeltas, steps


def _march(grid: UniformGrid, ro: Vec3, rd: Vec3, test_cell, carry0,
           stop_t_of, differentiable: bool = True):
    """Shared DDA driver: calls ``test_cell(carry, flat_cell, alive)`` per
    step; ``stop_t_of(carry)`` gives the per-ray distance past which the walk
    may stop (best-so-far for nearest-hit, the light distance for
    occlusion).

    ``differentiable=True`` runs a fixed-length ``lax.scan`` (reverse-mode
    safe; every ray pays the worst-case walk). ``False`` runs a
    ``lax.while_loop`` that stops when EVERY ray's walk is done — the
    early-out that makes the grid pay for forward rendering under XLA's
    static shapes."""
    rx, ry, rz = grid.res
    inside, t_enter, t_exit, cells, tmaxs, tdeltas, steps = _dda_setup(
        grid, ro, rd)

    def body(state, _):
        carry, ix, iy, iz, tmx, tmy, tmz, t_cur, alive = state
        flat = (iz * ry + iy) * rx + ix
        carry = test_cell(carry, flat, alive)
        # advance to the next cell along the smallest tMax
        pick_x = (tmx <= tmy) & (tmx <= tmz)
        pick_y = (~pick_x) & (tmy <= tmz)
        pick_z = (~pick_x) & (~pick_y)
        t_next = jnp.where(pick_x, tmx, jnp.where(pick_y, tmy, tmz))
        ix = jnp.where(pick_x, ix + steps[0], ix)
        iy = jnp.where(pick_y, iy + steps[1], iy)
        iz = jnp.where(pick_z, iz + steps[2], iz)
        tmx = jnp.where(pick_x, tmx + tdeltas[0], tmx)
        tmy = jnp.where(pick_y, tmy + tdeltas[1], tmy)
        tmz = jnp.where(pick_z, tmz + tdeltas[2], tmz)
        oob = ((ix < 0) | (ix >= rx) | (iy < 0) | (iy >= ry)
               | (iz < 0) | (iz >= rz))
        # stop when out of the grid, past the exit point, or when the next
        # cell begins strictly beyond anything that could still matter
        # (<= keeps exact-tie candidates reachable for the tie rule)
        alive = alive & (~oob) & (t_next <= t_exit + 1e-6) & (
            t_next <= stop_t_of(carry) + 1e-6)
        return (carry, ix, iy, iz, tmx, tmy, tmz, t_next, alive), None

    state0 = (carry0, cells[0], cells[1], cells[2],
              tmaxs[0], tmaxs[1], tmaxs[2], t_enter,
              inside & (t_enter <= stop_t_of(carry0)))
    if differentiable:
        (carry, *_), _ = jax.lax.scan(body, state0, None,
                                      length=max_steps(grid))
        return carry

    cap = max_steps(grid)

    def wcond(sc):
        s, state = sc
        return (s < cap) & jnp.any(state[-1])

    def wbody(sc):
        s, state = sc
        return s + 1, body(state, None)[0]

    _, (carry, *_) = jax.lax.while_loop(wcond, wbody, (jnp.int32(0), state0))
    return carry


def nearest_hit_grid(ro: Vec3, rd: Vec3, scene, grid: UniformGrid,
                     differentiable: bool = True) -> Hit:
    """Grid-accelerated nearest hit; same result as ``intersect.nearest_hit``
    (including tie semantics). ``differentiable=False`` uses the while-loop
    march (faster forward rendering, no reverse-mode)."""
    S = scene.num_spheres
    Ks = grid.sph_list.shape[1]
    Kt = grid.tri_list.shape[1]

    def test_cell(carry, flat, alive):
        best_t, best_i = carry
        if S:
            for j in range(Ks):
                sid = grid.sph_list[flat, j]
                ok = alive & (sid >= 0)
                si = jnp.clip(sid, 0, S - 1)
                t, valid = sphere_t(ro, rd, scene.sph_center.x[si],
                                    scene.sph_center.y[si],
                                    scene.sph_center.z[si],
                                    scene.sph_radius[si])
                best_t, best_i = _tie_min(best_t, best_i, t, valid & ok, si)
        if scene.num_triangles:
            T = scene.num_triangles
            for j in range(Kt):
                tid = grid.tri_list[flat, j]
                ok = alive & (tid >= 0)
                ti = jnp.clip(tid, 0, T - 1)
                v0 = Vec3(scene.tri_v0.x[ti], scene.tri_v0.y[ti],
                          scene.tri_v0.z[ti])
                v1 = Vec3(scene.tri_v1.x[ti], scene.tri_v1.y[ti],
                          scene.tri_v1.z[ti])
                v2 = Vec3(scene.tri_v2.x[ti], scene.tri_v2.y[ti],
                          scene.tri_v2.z[ti])
                t, _, _, valid = triangle_t(ro, rd, v0, v1, v2)
                best_t, best_i = _tie_min(best_t, best_i, t, valid & ok,
                                          ti + S)
        return best_t, best_i

    best_t0 = full_like_vma(ro.x, jnp.inf)
    best_i0 = full_like_vma(ro.x, -1, dtype=jnp.int32)
    best_t, best_i = _march(grid, ro, rd, test_cell, (best_t0, best_i0),
                            stop_t_of=lambda c: c[0],
                            differentiable=differentiable)
    return Hit(t=best_t, prim=best_i, hit=jnp.isfinite(best_t))


def any_hit_grid(ro: Vec3, rd: Vec3, max_dist, scene,
                 grid: UniformGrid, differentiable: bool = True) -> jax.Array:
    """Grid-accelerated occlusion query; same semantics as
    ``intersect.any_hit`` (a hit exactly at ``max_dist`` occludes)."""
    S = scene.num_spheres
    Ks = grid.sph_list.shape[1]
    Kt = grid.tri_list.shape[1]
    big = 1e30

    def test_cell(occ, flat, alive):
        live = alive & (~occ)
        if S:
            for j in range(Ks):
                sid = grid.sph_list[flat, j]
                ok = live & (sid >= 0)
                si = jnp.clip(sid, 0, S - 1)
                t, valid = sphere_t(ro, rd, scene.sph_center.x[si],
                                    scene.sph_center.y[si],
                                    scene.sph_center.z[si],
                                    scene.sph_radius[si])
                occ = occ | (ok & valid & (t <= max_dist))
        if scene.num_triangles:
            T = scene.num_triangles
            for j in range(Kt):
                tid = grid.tri_list[flat, j]
                ok = live & (tid >= 0)
                ti = jnp.clip(tid, 0, T - 1)
                v0 = Vec3(scene.tri_v0.x[ti], scene.tri_v0.y[ti],
                          scene.tri_v0.z[ti])
                v1 = Vec3(scene.tri_v1.x[ti], scene.tri_v1.y[ti],
                          scene.tri_v1.z[ti])
                v2 = Vec3(scene.tri_v2.x[ti], scene.tri_v2.y[ti],
                          scene.tri_v2.z[ti])
                t, _, _, valid = triangle_t(ro, rd, v0, v1, v2)
                occ = occ | (ok & valid & (t <= max_dist))
        return occ

    occ0 = full_like_vma(ro.x, False, dtype=bool)
    # an occluded ray stops marching (stop_t -> -inf), others walk to the
    # light distance
    return _march(grid, ro, rd, test_cell, occ0,
                  stop_t_of=lambda occ: jnp.where(occ, -big, max_dist),
                  differentiable=differentiable)
