"""Engine choice: the one rule the renderer, the CLI and the scripts share.

* ``"jnp"``: the differentiable masked-wavefront estimator
  (render/integrator.py), compiled by XLA for any backend.
* ``"pallas"``: the fused Pallas-Triton kernel (ops/pallas/megakernel.py),
  forward rendering on a GPU.
* ``"pallas_interpret"``: the same kernel in Pallas interpret mode — runs
  on the CPU; a test tool, only ever chosen explicitly.
* ``"auto"``: the fused kernel on a GPU, ``jnp`` everywhere else.
"""
from __future__ import annotations

FUSED_ENGINES = ("pallas", "pallas_interpret")
RENDER_ENGINES = ("auto", "jnp") + FUSED_ENGINES


def resolve_engine(engine: str = "auto", accel: str = "none",
                   backend: str | None = None) -> str:
    """Concrete engine for ``engine`` on ``backend`` (default: JAX's
    default backend). The fused kernel runs the linear primitive sweeps
    only, so ``accel="grid"`` resolves ``auto`` to ``jnp`` and refuses an
    explicit fused engine."""
    if engine not in RENDER_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"use one of {RENDER_ENGINES}")
    if engine == "auto":
        if backend is None:
            import jax
            backend = jax.default_backend()
        return "pallas" if backend == "gpu" and accel == "none" else "jnp"
    if engine in FUSED_ENGINES and accel == "grid":
        raise ValueError(
            f"engine={engine!r} has no grid traversal; accel='grid' runs on "
            "engine='jnp' (per-ray DDA, ops/grid.py)")
    return engine
