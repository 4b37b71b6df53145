"""Persistent JAX/XLA compilation cache.

JAX's in-process cache only helps within one interpreter. This module turns
on JAX's *persistent* compilation cache so compiled executables (the fused
Triton kernel included) survive process restarts — the second run of the
CLI, ``bench.py`` or a training script skips compilation.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the directory is
part of the cache's key, so only a path that does not move is ever found
again.

The reference has no analogue (CUDA kernels are AOT-compiled by nvcc at
build time, CudaTracer/Makefile); this is the JIT-world equivalent of that
build step being "already done".

Usage: call :func:`enable_persistent_cache` once before the first ``jit``
execution (the CLI, ``bench.py`` and ``chip_smoke.py`` do). Opt out with
``CPT_NO_COMPILE_CACHE=1``.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_persistent_cache(cache_dir: str | None = None) -> str | None:
    """Enable JAX's on-disk compilation cache; returns the directory in
    use, or ``None`` if disabled via ``CPT_NO_COMPILE_CACHE`` or unusable.

    ``$JAX_COMPILATION_CACHE_DIR`` wins and is left to JAX; otherwise
    ``cache_dir`` (default :data:`DEFAULT_CACHE_DIR`) is configured. Never
    raises: on any failure (read-only checkout) it degrades to the
    in-process cache."""
    if os.environ.get("CPT_NO_COMPILE_CACHE"):
        return None
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    try:
        import jax

        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        return cache_dir
    except Exception:
        return None
