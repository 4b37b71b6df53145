"""SPMD rendering over a device mesh.

The multi-card form of the reference's single-GPU pixel grid
(``CudaTracer.cu:598-599``): the flattened pixel wavefront is sharded over
the mesh's pixel axis with ``shard_map`` — each device traces only its tile
against the replicated scene, with zero communication in the forward pass.
Two reductions use collectives:

* sample-axis sharding: devices render the *same* tile with different sample
  indices and ``psum`` the radiance over the sample axis;
* gradients: scene/camera parameters are replicated, so their cotangents are
  all-reduced automatically by the ``shard_map`` transpose (the overlap of
  that psum with the backward pass is XLA's job, as it should be).

The pixel-sharded path is bitwise-identical to the single-device renderer
(same counter streams per pixel/sample). The sample-sharded path reorders
the floating-point sample sum across devices, so it matches to float
tolerance, not bitwise. Both asserted in tests/test_sharding.py.
"""
from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import DEFAULT_MAX_BOUNCES
from ..ops.vec import match_vma
from ..render.integrator import render_block
from .mesh import PATH_AXIS, PIXEL_AXIS, SAMPLE_AXIS


def _render_pixel_block(scene, cam_params, width, height, seed, spp,
                        max_bounces, live_cutoff, pixel_idx,
                        sample_offset=0, physical=False, nee=True,
                        bidir_nu=None):
    """Render ``spp`` samples for an arbitrary set of flat pixel indices.
    Per-pixel counter streams make this independent of how pixels are
    tiled over devices; ``sample_offset`` continues the global sample range
    (progressive accumulation across mesh reshapes stays exact)."""

    def body(acc, s):
        r = render_block(scene, cam_params, width, height, pixel_idx,
                         seed, s,
                         max_bounces=max_bounces, live_cutoff=live_cutoff,
                         physical=physical, nee=nee, bidir_nu=bidir_nu)
        return acc + r.to_array(), None

    n = pixel_idx.shape[0]
    # the accumulator carry must inherit the tile's varying manual axes
    acc0 = match_vma(pixel_idx, jnp.zeros((n, 3), jnp.float32))
    acc, _ = jax.lax.scan(body, acc0,
                          jnp.arange(spp) + jnp.asarray(sample_offset,
                                                        jnp.int32))
    return acc / spp


def render_pixel_sharded(scene, cam_params, width: int, height: int, spp: int,
                         seed, mesh: Mesh,
                         max_bounces: int = DEFAULT_MAX_BOUNCES,
                         live_cutoff: Optional[int] = None,
                         sample_offset=0, physical: bool = False,
                         nee: bool = True, bidir_nu=None):
    """Shard pixel tiles over ``mesh``'s pixel axis. Returns [H, W, 3].
    ``physical``/``nee`` select the estimator exactly as in
    ``render.integrator`` (per-pixel streams keep the pixel-sharded
    physical image bitwise-identical to the single-device one)."""
    n = width * height
    n_dev = mesh.shape[PIXEL_AXIS]
    if n % n_dev:
        raise ValueError(f"{width}x{height} pixels not divisible by {n_dev} devices")
    per_dev = n // n_dev

    def tile_fn(scene, cam_params, seed):
        dev = jax.lax.axis_index(PIXEL_AXIS)
        idx = dev * per_dev + jnp.arange(per_dev, dtype=jnp.int32)
        return _render_pixel_block(scene, cam_params, width, height, seed,
                                   spp, max_bounces, live_cutoff, idx,
                                   sample_offset, physical=physical, nee=nee,
                                   bidir_nu=bidir_nu)

    out = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(PIXEL_AXIS),
    )(scene, cam_params, seed)
    return out.reshape(height, width, 3)


def render_sample_sharded(scene, cam_params, width: int, height: int,
                          spp: int, seed, mesh: Mesh,
                          max_bounces: int = DEFAULT_MAX_BOUNCES,
                          live_cutoff: Optional[int] = None,
                          physical: bool = False, nee: bool = True):
    """Shard the sample axis: every device renders the whole image with its
    own slice of sample indices; one ``psum`` over the sample axis merges
    them. Right for small images at high spp.

    The mesh MUST have a ``SAMPLE_AXIS`` axis — silently re-using a
    pixel-named axis for samples would make the API lie about what a mesh
    spec means on a pod. Build one with ``parallel.mesh.make_mesh(n,
    axis=SAMPLE_AXIS)`` or a 2-D mesh and pass the right renderer."""
    if SAMPLE_AXIS not in mesh.shape:
        raise ValueError(
            f"render_sample_sharded needs a mesh with a {SAMPLE_AXIS!r} "
            f"axis; got axes {tuple(mesh.shape)}. Use "
            f"parallel.mesh.make_mesh(n, axis={SAMPLE_AXIS!r}) (or "
            "render_pixel_sharded for a pixel mesh)")
    n_dev = mesh.shape[SAMPLE_AXIS]
    axis = SAMPLE_AXIS
    if spp % n_dev:
        raise ValueError(f"spp={spp} not divisible by {n_dev} devices")
    per_dev = spp // n_dev

    def shard_fn(scene, cam_params, seed):
        dev = jax.lax.axis_index(axis)
        idx = jnp.arange(width * height, dtype=jnp.int32)

        def body(acc, k):
            s = dev * per_dev + k
            r = render_block(scene, cam_params, width, height, idx,
                             seed, s,
                             max_bounces=max_bounces, live_cutoff=live_cutoff,
                             physical=physical, nee=nee)
            return acc + r.to_array(), None

        acc0 = match_vma(dev, jnp.zeros((width * height, 3), jnp.float32))
        acc, _ = jax.lax.scan(body, acc0, jnp.arange(per_dev))
        return jax.lax.psum(acc, axis) / spp

    out = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
    )(scene, cam_params, seed)
    return out.reshape(height, width, 3)


def render_2d_sharded(scene, cam_params, width: int, height: int, spp: int,
                      seed, mesh: Mesh,
                      max_bounces: int = DEFAULT_MAX_BOUNCES,
                      live_cutoff: Optional[int] = None,
                      physical: bool = False, nee: bool = True):
    """2-D mesh: pixels shard over PIXEL_AXIS while samples shard over
    SAMPLE_AXIS; each device renders (its tile) x (its sample slice) and one
    psum over the sample axis merges. The canonical layout for many chips at
    moderate resolution. Bitwise-identical to the single-device renderer."""
    n = width * height
    n_px = mesh.shape[PIXEL_AXIS]
    n_sp = mesh.shape[SAMPLE_AXIS]
    if n % n_px:
        raise ValueError(f"{n} pixels not divisible by {n_px}")
    if spp % n_sp:
        raise ValueError(f"spp={spp} not divisible by {n_sp}")
    per_px = n // n_px
    per_sp = spp // n_sp

    def tile_fn(scene, cam_params, seed):
        px = jax.lax.axis_index(PIXEL_AXIS)
        sp = jax.lax.axis_index(SAMPLE_AXIS)
        idx = px * per_px + jnp.arange(per_px, dtype=jnp.int32)

        def body(acc, k):
            s = sp * per_sp + k
            r = render_block(scene, cam_params, width, height, idx,
                             seed, s,
                             max_bounces=max_bounces, live_cutoff=live_cutoff,
                             physical=physical, nee=nee)
            return acc + r.to_array(), None

        acc0 = match_vma(idx + sp, jnp.zeros((per_px, 3), jnp.float32))
        acc, _ = jax.lax.scan(body, acc0, jnp.arange(per_sp))
        return jax.lax.psum(acc, SAMPLE_AXIS) / spp

    out = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(PIXEL_AXIS),
    )(scene, cam_params, seed)
    return out.reshape(height, width, 3)


def render_lighttrace_sharded(scene, cam_params, width: int, height: int,
                              n_paths: int, seed, mesh: Mesh,
                              max_bounces: int = DEFAULT_MAX_BOUNCES,
                              sample_idx=0, bidir_nu=None):
    """Light tracing (render/lighttrace.py) sharded over ``mesh``'s
    ``PATH_AXIS``: each device traces a disjoint block of GLOBAL light-path
    indices and splats into its own full-image partial; one ``psum`` over
    the path axis merges the splats — unlike the forward renderers, every
    light path can touch every pixel, so this is the renderer where the
    collective does real per-pixel work (SURVEY §2 ICI row). Streams key on
    the global path index, so the per-path contributions are identical on
    any mesh; only the float summation ORDER differs from a single device
    (asserted to tight tolerance in tests/test_sharding.py)."""
    if not scene.num_area_lights:
        raise ValueError("light tracing needs at least one area light")
    if PATH_AXIS not in mesh.shape:
        raise ValueError(
            f"render_lighttrace_sharded needs a mesh with a {PATH_AXIS!r} "
            f"axis; got axes {tuple(mesh.shape)}. Build one with "
            f"parallel.mesh.make_mesh(n, axis={PATH_AXIS!r})")
    n_dev = mesh.shape[PATH_AXIS]
    if n_paths % n_dev:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_dev} devices")
    per_dev = n_paths // n_dev

    from ..render.lighttrace import lighttrace_block

    def shard_fn(scene, cam_params, seed):
        dev = jax.lax.axis_index(PATH_AXIS)
        idx = dev * per_dev + jnp.arange(per_dev, dtype=jnp.int32)
        img = lighttrace_block(scene, cam_params, width, height, idx, seed,
                               max_bounces=max_bounces,
                               sample_idx=sample_idx, bidir_nu=bidir_nu)
        return jax.lax.psum(img, PATH_AXIS) / n_paths

    out = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
    )(scene, cam_params, seed)
    return out.reshape(height, width, 3)


@functools.lru_cache(maxsize=32)
def _pixel_sharded_jit(width, height, spp, mesh, max_bounces, live_cutoff,
                       physical, nee):
    fn = partial(render_pixel_sharded, width=width, height=height, spp=spp,
                 mesh=mesh, max_bounces=max_bounces, live_cutoff=live_cutoff,
                 physical=physical, nee=nee)
    return jax.jit(lambda s, c, k: fn(s, c, seed=k))


def jit_pixel_sharded(scene, cam_params, width, height, spp, seed, mesh,
                      max_bounces=DEFAULT_MAX_BOUNCES, live_cutoff=None,
                      physical=False, nee=True):
    """Jitted entry point for the pixel-sharded renderer. The jitted callable
    is cached per configuration so repeated calls hit jax's compile cache
    (a fresh lambda per call would retrace every frame)."""
    fn = _pixel_sharded_jit(width, height, spp, mesh, max_bounces, live_cutoff,
                            physical, nee)
    return fn(scene, cam_params, seed)
