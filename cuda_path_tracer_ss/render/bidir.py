"""Bidirectional path tracing: forward eye paths + light-traced splats,
combined with multiple-importance-sampling weights.

The reference slated this as its last feature ("possibly bidirectional Path
Tracing", /root/reference/README.md:35) and never built it. The two halves
exist here as full engines — the forward ``--physical`` estimator
(render/integrator.py) and the light tracer (render/lighttrace.py) — and
each owns a path family the other struggles with: eye paths render
specular surfaces SEEN by the camera (glass, mirrors) but find caustics
only through vanishing-probability chains; light paths render caustics
directly but cannot reach the camera through a specular surface at all
(the black-glass artifact of a light-trace-only render). This module runs
both and MIS-weights every contribution so each family dominates exactly
where its sampling density is sharpest.

Technique space (restricted BDPT: the classic (s,t) strategy grid with
s ∈ {0, 1} from the forward tracer and t = 1 from the light tracer — the
three families that matter for this renderer's scenes):

* **BSDF hit** (s=0): the eye path's sampled continuation lands on an area
  light. Count = spp per pixel.
* **NEE** (s=1): the eye path light-samples each area light at each
  diffuse/glossy vertex. Count = spp.
* **Camera connection** (t=1): a light path connects a vertex to the
  pinhole and splats (plus the emitter-surface splat for pure Le pixels).
  Count = n_paths (global).

Weights are the power heuristic over (count x density): for technique k,
``w_k = (n_k p_k)^2 / sum_i (n_i p_i)^2``, implemented as ratio sums with
``nu = n_paths / spp`` folding the counts. Densities over a complete path
are products of per-vertex factors in area measure; both estimators carry
the cross-family ratio incrementally (the eye side as ``PathState.lt_chain``
et al., the light side as the ``U / r0 / pr`` carries in
``lighttrace_block``).

**Why this is unbiased regardless of pdf-model choices** — the weights sum
to 1 per labeled path because every per-vertex factor is evaluated by BOTH
sides through the same function (``ops/bsdf.chain_model_pdfs``) at the same
``(incoming, outgoing, label)`` arguments: the eye walking camera->light
and the light path walking light->camera visit the same vertices with the
same edge pairs, just in opposite orders (the "reverse pdf" of one side IS
the "forward pdf" of the other). Delta lobes use their branch probability
as a finite stand-in (Veach 10.3.5's practical treatment — exact for
mirrors, up to the refraction solid-angle Jacobian otherwise); MIS stays
unbiased for ANY consistent weights, the stand-in only affects variance.

Estimator-agreement, the caustic-variance win, and the visible-glass fix
are asserted in tests/test_bidir.py.

One scope note: on transport the reference's BSDF model makes
NON-RECIPROCAL (weight-1 refraction through curved glass — see the
quantified analysis in render/lighttrace.py), the two families estimate
slightly different integrals, and the MIS combination follows whichever
family carries the local weight: refraction-focused caustics take the
light-trace value (measured 1.36x the forward value at ior 1.5),
everything diffuse-visible converges to the forward estimator (<2%).
The weights still sum to 1 — the combination is a consistent estimator
of a blend, not a biased estimator of either.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import DEFAULT_MAX_BOUNCES
from ..utils import rng
from .integrator import render
from .lighttrace import render_lighttrace


@partial(jax.jit, static_argnames=("width", "height", "spp", "n_paths",
                                   "max_bounces"))
def render_bidir(scene, cam_params, width: int, height: int, spp: int,
                 n_paths: int, seed,
                 max_bounces: int = DEFAULT_MAX_BOUNCES,
                 sample_offset=0, light_sample_idx=0):
    """Combined bidirectional render -> [height, width, 3] radiance.

    ``spp`` eye samples per pixel plus ``n_paths`` light paths, each
    contribution MIS-weighted; the sum of the two partial images is an
    unbiased estimate of the same per-pixel means as the forward
    ``physical=True`` estimator. ``nu = n_paths / spp`` is the technique
    count ratio the weights use — more light paths shift weight toward the
    splats exactly where they are the sharper estimator.

    Batch for more samples like the halves: distinct ``sample_offset``
    (eye) and ``light_sample_idx`` (light) per batch, average the results.
    """
    if not scene.num_area_lights:
        raise ValueError("bidirectional rendering needs an area light "
                         "(use the forward estimator for point-light-only "
                         "scenes)")
    nu = float(n_paths) / float(spp)
    fwd = render(scene, cam_params, width, height, spp, seed,
                 max_bounces=max_bounces, live_cutoff=None,
                 sample_offset=sample_offset, physical=True, bidir_nu=nu)
    # decorrelate the two halves' counter streams (pixel ids and path ids
    # are both small ints, so sharing the seed would alias their keys)
    lt = render_lighttrace(scene, cam_params, width, height, n_paths,
                           rng.seed_for(seed, 1), max_bounces=max_bounces,
                           sample_idx=light_sample_idx, bidir_nu=nu)
    return fwd + lt


def render_bidir_sharded(scene, cam_params, width: int, height: int,
                         spp: int, n_paths: int, seed, mesh_pixels,
                         mesh_paths,
                         max_bounces: int = DEFAULT_MAX_BOUNCES,
                         sample_offset=0, light_sample_idx=0):
    """SPMD bidirectional render: the forward half shards pixel tiles over
    ``mesh_pixels`` (zero collectives) and the light half shards paths
    over ``mesh_paths`` with one psum merging the splats — two shard_maps
    over the same device set, each on the axis its estimator parallelizes
    naturally. Per-pixel/per-path counter streams use GLOBAL indices, so
    the result matches single-device ``render_bidir`` up to the light
    half's splat-sum reorder (tests/test_bidir.py)."""
    from ..parallel.sharding import (render_lighttrace_sharded,
                                     render_pixel_sharded)
    if not scene.num_area_lights:
        raise ValueError("bidirectional rendering needs an area light")
    nu = float(n_paths) / float(spp)
    fwd = render_pixel_sharded(scene, cam_params, width, height, spp, seed,
                               mesh_pixels, max_bounces=max_bounces,
                               live_cutoff=None,
                               sample_offset=sample_offset, physical=True,
                               bidir_nu=nu)
    lt = render_lighttrace_sharded(scene, cam_params, width, height,
                                   n_paths, rng.seed_for(seed, 1),
                                   mesh_paths, max_bounces=max_bounces,
                                   sample_idx=light_sample_idx,
                                   bidir_nu=nu)
    return fwd + lt
