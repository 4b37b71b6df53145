#!/usr/bin/env python
"""Headline benchmark: primary rays/s of the fused kernel on one GPU at the
800x800 Cornell scene, 8 bounces, 2000 spp (BASELINE.json metric). Prints
ONE JSON line naming the device and the card's name and power limit.

Baseline derivation (BASELINE.md): the reference reports 30-45 samples/pixel/s
at 512x512 on a GTX 760 => midpoint 37.5 * 512^2 = 9.83M primary rays/s.
``vs_baseline`` is our primary-rays/s over that midpoint.

Needs a GPU and exits non-zero without one: it never falls back to the CPU,
to interpret mode or to another engine.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from cuda_path_tracer_ss.utils.compile_cache import enable_persistent_cache

BASELINE_PRIMARY_RAYS_PER_S = 37.5 * 512 * 512  # 9.83M, GTX 760 midpoint

WIDTH = HEIGHT = 800
SPP = 2000    # the reference's quoted 30-45 spp/s is a progressive average
              # at ~2000 spp (README.md:32)
BOUNCES = 8
REPEATS = 2


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def measure() -> float:
    import jax.numpy as jnp

    from cuda_path_tracer_ss.models import presets
    from cuda_path_tracer_ss.models.camera import Camera
    from cuda_path_tracer_ss.ops.pallas.megakernel import (
        pack_scene, render_megakernel)
    from cuda_path_tracer_ss.render.integrator import camera_arrays

    # scene upload happens once, as the reference's cudaMemcpy setup does
    # (CudaTracer.cu:696-700)
    packed = jax.block_until_ready(pack_scene(presets.cornell()))
    cam_params = camera_arrays(Camera())

    def run(seed):
        return render_megakernel(packed, cam_params, jnp.int32(seed), WIDTH,
                                 HEIGHT, SPP, BOUNCES)

    jax.block_until_ready(run(0))      # compile + warm-up
    t0 = time.perf_counter()
    for i in range(REPEATS):
        img = run(1000 + i)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    if not bool(jnp.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise RuntimeError("benchmark image is not finite and positive")
    return WIDTH * HEIGHT * SPP * REPEATS / dt


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    enable_persistent_cache()
    rays_per_s = measure()
    print(json.dumps({
        "metric": "primary_rays_per_s_per_chip_800x800_cornell_8bounce",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_PRIMARY_RAYS_PER_S, 3),
        "engine": "pallas",
        "spp": SPP,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
    }))


if __name__ == "__main__":
    main()
