"""The path-tracing estimator: eye rays + static-shaped bounce wavefront.

Behavioral spec: the reference's per-frame hot path — ``computeEyeRay``
(``CudaTracer/CudaTracer.cu:321-343``), the ``pathTraceKernel`` bounce
recurrence (``CudaTracer.cu:106-206``, see SURVEY §3.4), the 15-bounce host
loop with thrust stream compaction and the <=128-live-ray early exit
(``CudaTracer.cu:620-633``).

Static-shape redesign for XLA:

* The ray buffer never shrinks. Instead of thrust::partition, rays carry an
  ``active`` mask and every bounce is a masked update over the full static
  wavefront — shapes stay constant so the whole loop jits and differentiates.
* Two loop drivers over the same ``bounce`` body:
  - ``lax.scan`` over the bounce axis: reverse-mode differentiable; the last
    bounce skips scattering exactly like the reference's ``isLastIteration``
    flag (a pure compute saving — scattered state is never read afterwards).
  - ``lax.while_loop`` with a live-ray-count early exit (the analog of
    ``numRays > 128``): faster for forward rendering, not differentiable.
* RNG is counter-based threefry on (seed, pixel, sample, pair) — no mutable
  generator state, and the streams are bitwise-shared with the Pallas
  megakernel (see utils/rng.py) so the two engines agree per pixel.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..constants import DEFAULT_MAX_BOUNCES, INV_PI, LIVE_RAY_CUTOFF
from ..ops.bsdf import UNIFORMS_PER_SCATTER, lookup_materials, scatter
from ..ops.intersect import nearest_hit, surfel_at
from ..ops.shading import UNIFORMS_PER_AREA_LIGHT, shade
from ..ops.vec import Vec3, full_like_vma, match_vma, where as vwhere
from ..utils import rng


class PathState(NamedTuple):
    origin: Vec3       # [N]
    direction: Vec3    # [N]
    radiance: Vec3     # [N] accumulated estimate (reference ``radiance0``)
    throughput: Vec3   # [N] path throughput (reference ``radiance1``)
    active: jax.Array  # [N] bool
    prev_pdf: jax.Array  # [N] f32: effective solid-angle density with which
                         # the last scatter sampled the current direction,
                         # for branches NEE competes with — diffuse
                         # (diff_avg cos/pi) and Phong glossy
                         # (p_spec (n+1)/2pi cos^n alpha); 0 after delta /
                         # Cook-Torrance / refraction branches, inside
                         # hits, and camera rays. Drives the physical
                         # mode's MIS emission weight; always 0 in the
                         # reference-parity estimator.
    # ---- bidirectional-MIS carry (render/bidir.py; zeros unless the
    # estimator runs with bidir_nu set — XLA dead-code-eliminates them
    # otherwise). All in the CHAIN-MODEL pdf convention of
    # ops/bsdf.chain_model_pdfs.
    lt_chain: jax.Array     # [N] S_k = prod lambda_{2..k} / (C_A prod
                            # e_{1..k-1}): the light-tracer-over-eye density
                            # ratio of the path prefix, updated each scatter;
                            # carries the [first bounce was diffuse & front]
                            # indicator that gates the light tracer's camera
                            # connection.
    prev_pdf_model: jax.Array  # [N] chain-model fwd density of the last
                               # scatter (branch prob for delta lobes —
                               # NOT the 0-for-delta prev_pdf convention)
    prev_cos_out: jax.Array    # [N] |n_hat . d_out| at the last vertex
    j_img: jax.Array           # [N] dA_img/dOmega of the eye ray (the
                               # camera importance J, lighttrace.py) —
                               # constant per path, set by render_block


def camera_arrays(camera):
    """Host camera -> jittable parameter pytree (all differentiable)."""
    rot, pos, tan_half_fov, z_near = camera.device_params()
    return (jnp.asarray(rot), jnp.asarray(pos), jnp.asarray(tan_half_fov),
            jnp.asarray(z_near))


def eye_rays_for_indices(cam_params, width: int, height: int, pixel_idx,
                         jitter_x, jitter_y):
    """Jittered pinhole eye rays for an arbitrary set of flat pixel indices
    — ``computeEyeRay`` (CudaTracer.cu:321-343). Taking indices (rather than
    assuming the full image) is what lets a device mesh trace disjoint pixel
    tiles with identical per-pixel results.

    Pixel (0,0) is the bottom-left (GL convention, as the reference's
    framebuffer). Returns (origins, directions) as Vec3 of [len(pixel_idx)].
    """
    rot, pos, tan_half_fov, z_near = cam_params
    n = pixel_idx.shape[0]
    px = (pixel_idx % width).astype(jnp.float32) + jitter_x
    py = (pixel_idx // width).astype(jnp.float32) + jitter_y

    s = -2.0 * tan_half_fov
    aspect = height / width  # reference uses 1 (square DIM x DIM)
    sx = (px / width - 0.5) * s * z_near
    sy = (py / height - 0.5) * s * aspect * z_near
    sz = jnp.full((n,), 1.0, jnp.float32) * z_near

    d = Vec3(
        rot[0, 0] * sx + rot[0, 1] * sy + rot[0, 2] * sz,
        rot[1, 0] * sx + rot[1, 1] * sy + rot[1, 2] * sz,
        rot[2, 0] * sx + rot[2, 1] * sy + rot[2, 2] * sz,
    ).normalize(eps=1e-20)
    # Origins broadcast from the replicated camera position; under shard_map
    # they must still carry the rays' varying manual axes (directions do, via
    # pixel_idx), or downstream scan carries are ill-typed.
    o = Vec3(jnp.broadcast_to(pos[0], (n,)), jnp.broadcast_to(pos[1], (n,)),
             jnp.broadcast_to(pos[2], (n,))).map(lambda a: match_vma(d.x, a))
    return o, d


def uniforms_per_bounce(scene) -> int:
    return UNIFORMS_PER_SCATTER + UNIFORMS_PER_AREA_LIGHT * scene.num_area_lights


def bounce(scene, state: PathState, uniforms, do_scatter: bool = True,
           grid=None, grid_diff: bool = True, physical: bool = False,
           nee: bool = True, light_area_table=None,
           bidir_nu: Optional[float] = None, bounce_idx=None) -> PathState:
    """One wavefront bounce — the recurrence of SURVEY §3.4
    (pathTraceKernel body, CudaTracer.cu:106-206), masked over ``active``.
    ``grid`` (ops/grid.UniformGrid) accelerates the intersection and shadow
    sweeps with the DDA walk; results are identical to the linear sweeps
    (same tie semantics), so it is a pure speed knob for large scenes.

    ``physical=True`` switches to the unbiased estimator (a capability the
    reference lacks): uniform-area light sampling with the correct measure
    (ops/shading.shade_physical) combined with BSDF sampling by the power
    heuristic — NEE contributions carry w_l = p_l^2/(p_l^2 + p_b^2) and a
    BSDF-sampled hit on a light carries the complementary
    w_b = p_b^2/(p_b^2 + p_l^2), so nothing is double-counted and each
    strategy dominates where its density is sharpest. ``nee=False``
    (physical mode only) disables light sampling entirely, leaving the pure
    BSDF-sampling estimator — the two agree in expectation, which is the
    unbiasedness test."""
    if grid is None:
        hit = nearest_hit(state.origin, state.direction, scene)
    else:
        from ..ops.grid import nearest_hit_grid
        hit = nearest_hit_grid(state.origin, state.direction, scene, grid,
                               differentiable=grid_diff)
    surfel = surfel_at(state.origin, state.direction, hit, scene)
    m = lookup_materials(scene.materials, surfel.mat)
    if scene.num_textures:
        # color map modulates the diffuse albedo, normal map perturbs the
        # shading normal (ops/texture.py); no RNG consumption, so textured
        # and untextured scenes share per-pixel streams
        from ..ops.texture import apply_maps
        m, surfel = apply_maps(scene, state.origin, state.direction, hit,
                               surfel, m)

    cos_i = (-state.direction).dot(surfel.normal)
    inside = cos_i <= 0.0
    act_hit = state.active & hit.hit

    # ---- bidirectional-MIS chain quantities (render/bidir.py). T is the
    # nu-free ratio p_LT-prefix / p_eye-prefix of the path up to and
    # including the segment INTO this vertex — at the primary hit the eye
    # prefix is the camera vertex density C_A = J_img cos / t^2, deeper
    # it divides the carried S by the arrival segment's eye density e.
    bidir = physical and nee and (bidir_nu is not None)
    bd_nee = None
    if bidir:
        n_unit_b = surfel.normal.normalize(eps=1e-12)
        cos_arr = jnp.abs(state.direction.dot(n_unit_b))
        t2_arr = jnp.maximum(jnp.where(hit.hit, hit.t, 1.0) ** 2, 1e-12)
        is_primary = jnp.asarray(bounce_idx == 0)
        c_a = state.j_img * cos_arr / t2_arr
        e_prev = state.prev_pdf_model * cos_arr / t2_arr
        from ..constants import MIS_RATIO_CLAMP
        # clamped like the light tracer's U carry: at the ceiling every
        # weight this ratio feeds is already 0, and an inf carry would
        # NaN the forward 0*inf gates and every product's VJP
        T = jnp.minimum(
            jnp.where(is_primary, 1.0 / jnp.maximum(c_a, 1e-20),
                      state.lt_chain / jnp.maximum(e_prev, 1e-20)),
            MIS_RATIO_CLAMP)
        L_lights = max(scene.num_area_lights, 1)
        from ..ops.shading import BidirNEE
        bd_nee = BidirNEE(mult=(bidir_nu / L_lights) * T,
                          out_dir=-state.direction,
                          m=m, normal=surfel.normal,
                          prev_cos_out=state.prev_cos_out,
                          t2_arr=t2_arr, is_primary=is_primary)

    # Direct light: emission always, NEE only from outside (CudaTracer.cu:158-169).
    gloss = None
    ct_lobe = None
    if physical and nee:
        # The specular lobes scatter() would draw at this surfel — so NEE
        # can light-sample them too (MIS pairs #2 and #3): the Phong glossy
        # lobe for non-Cook-Torrance materials, the Beckmann microfacet
        # lobe for Cook-Torrance ones. Delta cases carry density 0 and are
        # never light-sampled (infinite Phong exponent via phong_pdf;
        # roughness==0 via prob=0 here).
        from ..ops.optics import (fresnel_reflectance, media_and_sin_t2,
                                  reflect_signed)
        from ..ops.sampling import phong_lobe_axis
        from ..ops.shading import CTLobe, GlossLobe
        cos_i_pos, sin_t2, n1, n2, _ = media_and_sin_t2(m.ior, cos_i)
        fres = fresnel_reflectance(cos_i_pos, sin_t2, n1, n2)
        pure = (m.flags & 0x01) != 0
        ct = (m.flags & 0x03) != 0
        p_spec = m.spec_avg * jnp.where(pure, 1.0, fres)
        gloss = GlossLobe(
            axis=phong_lobe_axis(
                reflect_signed(state.direction, surfel.normal, cos_i_pos)),
            exponent=m.spec_exp,
            weight=m.specular,
            prob=jnp.where(ct, 0.0, p_spec))
        ct_lobe = CTLobe(
            axis=phong_lobe_axis(surfel.normal),
            roughness=m.roughness,
            weight=m.specular,
            prob=jnp.where(ct & (m.roughness > 0.0), p_spec, 0.0),
            d=state.direction,
            normal=surfel.normal,
            nv=jnp.maximum(jnp.abs(cos_i), 1e-6))
    if physical:
        zeros3 = Vec3.zeros(cos_i.shape)
        if nee:
            from ..ops.shading import light_areas, shade_physical
            nee_l = shade_physical(scene, surfel.point, surfel.normal,
                                   m.diffuse, m.diff_avg,
                                   uniforms[UNIFORMS_PER_SCATTER:],
                                   grid=grid, grid_diff=grid_diff, mis=True,
                                   gloss=gloss, ct=ct_lobe, bidir=bd_nee)
            # MIS weight for BSDF-sampled emission: complementary to the
            # NEE weight of the light this ray hit. prev_pdf == 0 means the
            # previous scatter was not diffuse (or this is a camera ray) —
            # NEE never competed, weight 1. Hits on emissive surfaces that
            # are NOT registered area lights also keep weight 1.
            S = scene.num_spheres
            if scene.num_area_lights and scene.num_triangles:
                areas = (light_area_table if light_area_table is not None
                         else light_areas(scene))
                ti = jnp.clip(hit.prim - S, 0, scene.num_triangles - 1)
                a_hit = jnp.where(hit.prim >= S, areas[ti], 0.0)
                # cos at the light from its GEOMETRIC normal — the same
                # normal shade_physical's p_l uses, so the two weights are
                # exactly complementary (the interpolated shading normal
                # can differ on smooth meshes)
                e1 = Vec3(scene.tri_v1.x[ti] - scene.tri_v0.x[ti],
                          scene.tri_v1.y[ti] - scene.tri_v0.y[ti],
                          scene.tri_v1.z[ti] - scene.tri_v0.z[ti])
                e2 = Vec3(scene.tri_v2.x[ti] - scene.tri_v0.x[ti],
                          scene.tri_v2.y[ti] - scene.tri_v0.y[ti],
                          scene.tri_v2.z[ti] - scene.tri_v0.z[ti])
                n_geom = e1.cross(e2).normalize(eps=1e-12)
            else:
                a_hit = jnp.zeros_like(cos_i)
                n_geom = surfel.normal.normalize(eps=1e-12)
            cos_l_hit = jnp.abs(state.direction.dot(n_geom))
            t_hit = jnp.where(hit.hit, hit.t, 1.0)
            p_l_hit = (t_hit * t_hit) / jnp.maximum(a_hit * cos_l_hit,
                                                    1e-12)
            p_b = state.prev_pdf
            if bidir:
                # three-way weight: BSDF-hit vs NEE vs the light tracer's
                # camera connection (k=1: vs the emitter-surface splat).
                # Ratios are measure-free: r_nee in solid angle at this
                # vertex (prefix chains shared), rho over full area-measure
                # chains via T (chains disjoint).
                from ..constants import MIS_RATIO_CLAMP
                r_nee = jnp.where(p_b > 0.0,
                                  p_l_hit / jnp.maximum(p_b, 1e-20), 0.0)
                inv_pl_a = 1.0 / jnp.maximum(L_lights * a_hit, 1e-20)
                l_emit_hit = (0.5 * cos_l_hit * INV_PI
                              * state.prev_cos_out / t2_arr)
                rho = (bidir_nu * inv_pl_a
                       * jnp.where(is_primary, 1.0, l_emit_hit) * T)
                # clamp before squaring: r ~ 1e20 squares to inf, whose
                # reverse-mode cotangent is NaN (constants.py rationale)
                r_nee = jnp.minimum(r_nee, MIS_RATIO_CLAMP)
                rho = jnp.minimum(rho, MIS_RATIO_CLAMP)
                w_emit = jnp.where(
                    a_hit > 0.0,
                    1.0 / (1.0 + r_nee * r_nee + rho * rho), 1.0)
            else:
                w_emit = jnp.where(
                    (p_b > 0.0) & (a_hit > 0.0),
                    (p_b * p_b) / jnp.maximum(p_b * p_b + p_l_hit * p_l_hit,
                                              1e-20),
                    1.0)
            direct = m.emission * w_emit + vwhere(~inside, nee_l, zeros3)
        else:
            direct = m.emission
    else:
        nee_l = shade(scene, surfel.point, surfel.normal, m.diffuse,
                      m.diff_avg, uniforms[UNIFORMS_PER_SCATTER:], grid=grid,
                      grid_diff=grid_diff)
        direct = m.emission + vwhere(~inside, nee_l, Vec3.zeros(cos_i.shape))

    # Beer-Lambert absorbance over the interior path length (CudaTracer.cu:179-185).
    t_safe = jnp.where(hit.hit, hit.t, 0.0)
    beer = Vec3(
        jnp.exp(-t_safe * m.absorption.x),
        jnp.exp(-t_safe * m.absorption.y),
        jnp.exp(-t_safe * m.absorption.z),
    )
    throughput = vwhere(act_hit & inside, state.throughput * beer, state.throughput)

    radiance = state.radiance + vwhere(act_hit, throughput * direct,
                                       Vec3.zeros(cos_i.shape))
    # Miss: add background, kill the ray (CudaTracer.cu:193-198).
    miss = state.active & ~hit.hit
    radiance = radiance + vwhere(miss, scene.background * state.throughput,
                                 Vec3.zeros(cos_i.shape))
    active = state.active & hit.hit

    origin, direction = state.origin, state.direction
    prev_pdf = state.prev_pdf
    lt_chain = state.lt_chain
    prev_pdf_model = state.prev_pdf_model
    prev_cos_out = state.prev_cos_out
    if do_scatter:
        sc = scatter(state.direction, surfel.point, surfel.normal, m, cos_i,
                     uniforms[0], uniforms[1], uniforms[2])
        origin = vwhere(act_hit, sc.origin, origin)
        direction = vwhere(act_hit, sc.direction, direction)
        throughput = vwhere(act_hit, throughput * sc.weight, throughput)
        active = active & sc.alive
        if physical and nee:
            # Labeled cascade densities of the sampled continuation —
            # shared evaluation form (ops/bsdf.py::scatter_lobe_pdfs; the
            # Cook-Torrance quirk branch scores 0 -> full emission weight,
            # see CTLobe in ops/shading.py)
            from ..ops.bsdf import scatter_lobe_pdfs
            pdf_diff, pdf_gloss, pdf_ct = scatter_lobe_pdfs(
                state.direction, surfel.normal, m, cos_i, sc.direction)
            pdf_new = jnp.where(
                sc.diffuse_branch, pdf_diff,
                jnp.where(sc.gloss_branch, pdf_gloss,
                          jnp.where(sc.ct_branch, pdf_ct, 0.0)))
            # inside hits got NO NEE (direct zeroed above) — their
            # continuation has no light-sampling competitor, so the next
            # emission hit must carry full weight (prev_pdf = 0), else
            # energy is silently lost
            prev_pdf = jnp.where(act_hit,
                                 jnp.where(~inside, pdf_new, 0.0),
                                 prev_pdf)
        if bidir:
            # chain-model densities of the taken branch, both directions —
            # the SAME function the light tracer calls with the SAME (in,
            # out) pairs at this vertex, which is what makes the two
            # estimators' weights sum to 1 exactly (ops/bsdf.py doc)
            from ..ops.bsdf import chain_model_pdf_taken
            pdf_fwd_m = chain_model_pdf_taken(state.direction, surfel.normal,
                                              m, cos_i, sc.direction, sc)
            cos_i_rev = sc.direction.dot(surfel.normal)
            pdf_rev_m = chain_model_pdf_taken(-sc.direction, surfel.normal,
                                              m, cos_i_rev,
                                              -state.direction, sc)
            lam_full = pdf_rev_m * state.prev_cos_out / t2_arr
            s_new = jnp.minimum(jnp.where(
                is_primary,
                jnp.where(sc.diffuse_branch & (cos_i > 0.0), 1.0, 0.0)
                / jnp.maximum(c_a, 1e-20),
                T * lam_full), MIS_RATIO_CLAMP)  # see the T clamp above
            lt_chain = jnp.where(act_hit, s_new, lt_chain)
            prev_pdf_model = jnp.where(act_hit, pdf_fwd_m, prev_pdf_model)
            prev_cos_out = jnp.where(
                act_hit, jnp.abs(sc.direction.dot(n_unit_b)), prev_cos_out)

    return PathState(origin=origin, direction=direction, radiance=radiance,
                     throughput=throughput, active=active,
                     prev_pdf=prev_pdf, lt_chain=lt_chain,
                     prev_pdf_model=prev_pdf_model,
                     prev_cos_out=prev_cos_out, j_img=state.j_img)


def initial_state(origins: Vec3, directions: Vec3,
                  j_img=None) -> PathState:
    # full_like_vma initializers inherit the rays' varying manual axes so
    # the bounce scan/while carries typecheck inside shard_map.
    zeros = origins.map(lambda a: full_like_vma(a, 0.0))
    ones = origins.map(lambda a: full_like_vma(a, 1.0))
    return PathState(
        origin=origins,
        direction=directions,
        radiance=zeros,
        throughput=ones,
        active=full_like_vma(origins.x, True, dtype=bool),
        prev_pdf=full_like_vma(origins.x, 0.0),
        lt_chain=full_like_vma(origins.x, 0.0),
        prev_pdf_model=full_like_vma(origins.x, 0.0),
        prev_cos_out=full_like_vma(origins.x, 1.0),
        j_img=(full_like_vma(origins.x, 0.0) if j_img is None
               else match_vma(origins.x, j_img)),
    )


def eye_j_img(cam_params, d: Vec3, width: int, height: int):
    """Camera importance ``J_img = dA_img/dOmega`` of unit eye directions
    ``d`` — identical to the light tracer's splat Jacobian
    (lighttrace.py::camera_splat_weights), so the two estimators price the
    camera vertex with the same number."""
    rot, _, thf, _ = cam_params
    vz = rot[0, 2] * d.x + rot[1, 2] * d.y + rot[2, 2] * d.z
    cos_t = jnp.clip(jnp.abs(vz), 1e-4, 1.0)
    s = -2.0 * thf
    aspect = height / width
    return (width * height) / (s * s * aspect * cos_t ** 3)


def trace(scene, origins: Vec3, directions: Vec3, seed, sample_idx, pixel_idx,
          max_bounces: int = DEFAULT_MAX_BOUNCES,
          live_cutoff: Optional[int] = None, grid=None,
          physical: bool = False, nee: bool = True,
          bidir_nu: Optional[float] = None, j_img=None) -> Vec3:
    """Trace the wavefront to completion; returns per-ray radiance.

    ``pixel_idx`` identifies each ray's flat pixel for its RNG stream;
    ``(seed, sample_idx)`` complete the counter (utils/rng.py).
    ``live_cutoff=None`` -> differentiable ``lax.scan`` over bounces.
    ``live_cutoff=k``    -> forward-only ``lax.while_loop`` that stops when
    at most ``k`` rays remain live (reference: 128, CudaTracer.cu:622).
    ``physical``/``nee``: estimator mode (see ``bounce``).
    """
    if bidir_nu is not None and live_cutoff is not None:
        raise ValueError("bidir_nu requires the scan driver "
                         "(live_cutoff=None)")
    state0 = initial_state(origins, directions, j_img=j_img)

    # the while-loop march is forward-only, exactly like the live_cutoff
    # while-loop driver below; the scan driver keeps the differentiable scan
    grid_diff = live_cutoff is None

    # static scene quantity the MIS weights consult every bounce — computed
    # once here so it becomes a loop constant instead of being re-emitted
    # (and saved as a residual) inside every scan/while iteration
    area_table = None
    if physical and nee and scene.num_area_lights and scene.num_triangles:
        from ..ops.shading import light_areas
        area_table = light_areas(scene)

    def step(state, b, do_scatter=True):
        u = rng.bounce_rows(seed, pixel_idx, sample_idx, b,
                            scene.num_area_lights)
        return bounce(scene, state, u, do_scatter=do_scatter, grid=grid,
                      grid_diff=grid_diff, physical=physical, nee=nee,
                      light_area_table=area_table, bidir_nu=bidir_nu,
                      bounce_idx=b)

    if live_cutoff is None:
        if max_bounces > 1:
            state, _ = jax.lax.scan(
                lambda s, b: (step(s, b), None),
                state0, jnp.arange(max_bounces - 1))
        else:
            state = state0
        state = step(state, max_bounces - 1, do_scatter=False)
        return state.radiance

    def cond(carry):
        b, state = carry
        live = jnp.sum(state.active)
        return (b < max_bounces) & ((b == 0) | (live > live_cutoff))

    def body(carry):
        b, state = carry
        return b + 1, step(state, b)

    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state0))
    return state.radiance


def render_block(scene, cam_params, width: int, height: int, pixel_idx,
                 seed, sample_idx, max_bounces: int = DEFAULT_MAX_BOUNCES,
                 live_cutoff: Optional[int] = None, grid=None,
                 physical: bool = False, nee: bool = True,
                 bidir_nu: Optional[float] = None) -> Vec3:
    """One sample for an arbitrary block of pixels: jittered eye rays + full
    path trace. The unit of work a device traces in sharded rendering."""
    jx, jy = rng.eye_jitter(seed, pixel_idx, sample_idx)
    origins, directions = eye_rays_for_indices(
        cam_params, width, height, pixel_idx, jx, jy)
    j = (eye_j_img(cam_params, directions, width, height)
         if bidir_nu is not None else None)
    return trace(scene, origins, directions, seed, sample_idx, pixel_idx,
                 max_bounces=max_bounces, live_cutoff=live_cutoff, grid=grid,
                 physical=physical, nee=nee, bidir_nu=bidir_nu, j_img=j)


def render_sample(scene, cam_params, width: int, height: int, seed,
                  sample_idx, max_bounces: int = DEFAULT_MAX_BOUNCES,
                  live_cutoff: Optional[int] = None, grid=None,
                  physical: bool = False, nee: bool = True,
                  bidir_nu: Optional[float] = None) -> Vec3:
    """One sample per pixel over the whole image.
    Returns radiance as Vec3 of [W*H] (row 0 = bottom of image)."""
    pixel_idx = jnp.arange(width * height, dtype=jnp.int32)
    return render_block(scene, cam_params, width, height, pixel_idx,
                        seed, sample_idx, max_bounces=max_bounces,
                        live_cutoff=live_cutoff, grid=grid,
                        physical=physical, nee=nee, bidir_nu=bidir_nu)


@partial(jax.jit, static_argnames=("width", "height", "max_bounces"))
def live_ray_stats(scene, cam_params, width: int, height: int, seed,
                   max_bounces: int = DEFAULT_MAX_BOUNCES):
    """Wavefront occupancy: fraction of rays still live entering each bounce
    (the observable the reference prints implicitly via its shrinking
    ``numRays``, CudaTracer.cu:622-632). Returns [max_bounces] floats."""
    n = width * height
    pixel_idx = jnp.arange(n, dtype=jnp.int32)
    jx, jy = rng.eye_jitter(seed, pixel_idx, 0)
    o, d = eye_rays_for_indices(cam_params, width, height, pixel_idx, jx, jy)
    state0 = initial_state(o, d)

    def body(state, b):
        frac = jnp.mean(state.active.astype(jnp.float32))
        u = rng.bounce_rows(seed, pixel_idx, 0, b, scene.num_area_lights)
        return bounce(scene, state, u), frac

    _, fracs = jax.lax.scan(body, state0, jnp.arange(max_bounces))
    return fracs


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_bounces",
                                   "live_cutoff", "physical", "nee",
                                   "bidir_nu"))
def render(scene, cam_params, width: int, height: int, spp: int, seed,
           max_bounces: int = DEFAULT_MAX_BOUNCES,
           live_cutoff: Optional[int] = LIVE_RAY_CUTOFF,
           sample_offset=0, grid=None, physical: bool = False,
           nee: bool = True, bidir_nu: Optional[float] = None):
    """Render ``spp`` samples/pixel in one jitted scan; returns the mean
    radiance image as a ``[height, width, 3]`` float32 array. Samples use
    global indices ``sample_offset .. sample_offset+spp`` so progressive /
    sharded accumulation reproduces a single monolithic render exactly.
    ``physical=True`` selects the unbiased estimator (see ``bounce``)."""
    n = width * height

    def body(acc, s):
        r = render_sample(scene, cam_params, width, height, seed, s,
                          max_bounces=max_bounces, live_cutoff=live_cutoff,
                          grid=grid, physical=physical, nee=nee,
                          bidir_nu=bidir_nu)
        return acc + r.to_array(), None

    acc, _ = jax.lax.scan(body, jnp.zeros((n, 3), jnp.float32),
                          jnp.arange(spp) + jnp.asarray(sample_offset, jnp.int32))
    return (acc / spp).reshape(height, width, 3)
