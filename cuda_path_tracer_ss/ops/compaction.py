"""Wavefront compaction: the ``thrust::partition`` analog (reference C10,
``CudaTracer.cu:629-631``).

Under XLA's static shapes the buffer can never shrink, so "compaction" has
two static-shape forms:

* **Masking** (the default everywhere in this framework): rays carry an
  ``active`` flag; dead lanes still flow through every op but every update
  is masked. Zero data movement.
* **Sorting** (this module): a stable key-sort moves live rays into a dense
  prefix, preserving the reference's partition semantics exactly (stable =
  thrust::partition's relative-order guarantee is *stronger* than needed —
  thrust::partition is unstable — so images stay deterministic).

Sorting buys nothing for the XLA wavefront in principle — the whole static
buffer is processed regardless, so the sort's shuffle is pure overhead
(its cost on the GPU is not measured). The fused kernel needs neither: its
persistent path regeneration restarts a dead lane on its pixel's next
sample (ops/pallas/megakernel.py). Kept as a first-class op for scenes with
incoherent death patterns and for parity with the reference's
architecture.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def partition_by_activity(state):
    """Stable-partition any pytree of [N]-leading arrays so entries where
    ``state.active`` is True form a dense prefix. Returns (state, live_count).
    """
    active = state.active
    # stable argsort of (not active): False (live) sorts first
    order = jnp.argsort(jnp.logical_not(active), stable=True)
    new_state = jax.tree.map(lambda a: a[order], state)
    return new_state, jnp.sum(active)


def live_count(state) -> jax.Array:
    return jnp.sum(state.active)
