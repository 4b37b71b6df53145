"""Device mesh construction.

The reference is single-process single-GPU (SURVEY §2 "Parallelism &
communication"); its only parallel axis is SIMT over pixels. Here the same
axis becomes an SPMD data-parallel axis over a ``jax.sharding.Mesh``: image
tiles shard across devices, the scene replicates, and collectives (XLA
hands them to NCCL over NVLink, all to all) run inside ``shard_map``. Multi-host initialization is a thin wrapper over
``jax.distributed``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PIXEL_AXIS = "pixels"
SAMPLE_AXIS = "samples"
# Light-path axis for the light-tracing (adjoint) renderer: paths shard over
# devices and the splat image merges with one psum — the one renderer whose
# forward pass does real collective work (every device touches every pixel).
PATH_AXIS = "paths"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = PIXEL_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh_2d(n_pixel: int, n_sample: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: pixel tiles x sample groups. The layout follows the
    algorithm alone: every card of the host reaches every other at the
    same NVLink rate."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_pixel * n_sample]).reshape(n_sample, n_pixel)
    return Mesh(devices, (SAMPLE_AXIS, PIXEL_AXIS))


def pixel_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PIXEL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-process bring-up (``jax.distributed.initialize``). Nothing
    tells JAX of a cluster on a plain GPU host, so pass ``coordinator``
    (``host:port``), ``num_processes`` and ``process_id``. Safe to call once
    per process before any computation."""
    kwargs = {}
    if coordinator is not None:
        kwargs.update(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
