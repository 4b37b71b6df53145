#!/usr/bin/env python
"""Gradient-step throughput of the jnp engine (jax.grad under XLA).

Measures one jitted value_and_grad step of the inverse-rendering MSE loss
(render/inverse.py::make_loss) — the workload behind `cli invert`: Cornell,
8 bounces, fields materials.diffuse + al_power, then a wider field set.
Each step ends with jax.block_until_ready; the first call (compile) is
reported apart.

Usage: python scripts/bench_grad.py [width] [spp] [repeats]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render import inverse
from cuda_path_tracer_ss.render.integrator import camera_arrays

SIZE = int(sys.argv[1]) if len(sys.argv) > 1 else 256
SPP = int(sys.argv[2]) if len(sys.argv) > 2 else 16
REPEATS = int(sys.argv[3]) if len(sys.argv) > 3 else 5
BOUNCES = 8
FIELDS = ("materials.diffuse", "al_power")
FIELDS_FULL = FIELDS + ("materials.roughness", "materials.ior")


def measure(fields):
    scene = presets.cornell()
    cp = camera_arrays(Camera())
    target = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    loss = inverse.make_loss(scene, cp, target, SIZE, SIZE, SPP,
                             max_bounces=BOUNCES, field_names=fields)
    params = inverse.extract_params(scene, fields)
    step = jax.jit(jax.value_and_grad(loss))
    seed = jnp.int32(7)

    t0 = time.perf_counter()
    jax.block_until_ready(step(params, seed))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        val, grads = step(params, seed)
    jax.block_until_ready((val, grads))
    dt = (time.perf_counter() - t0) / REPEATS
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"{','.join(fields)}: {dt * 1e3:9.1f} ms/grad-step  "
          f"{SIZE * SIZE * SPP / dt / 1e6:7.1f} M primary rays/s (fwd+bwd)  "
          f"[compile+first {compile_s:.1f} s]  peak_bytes_in_use {peak}  "
          f"loss={float(val):.6f}", flush=True)
    return dt


def main():
    dev = jax.devices()[0]
    print(f"grad step: cornell {SIZE}x{SIZE}, {SPP} spp, {BOUNCES} bounces, "
          f"{REPEATS} reps, device {dev.platform} {dev.device_kind}",
          flush=True)
    measure(FIELDS)
    measure(FIELDS_FULL)


if __name__ == "__main__":
    main()
