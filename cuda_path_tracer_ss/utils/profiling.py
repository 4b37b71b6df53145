"""Profiling and observability.

The reference's entire story is one cudaEvent pair + a console line
(``CudaTracer.h:37``, ``CudaTracer.cu:611-646``). Equivalents here:

* ``timed``: wall-clock a jitted callable, each call ended with
  ``jax.block_until_ready`` (JAX returns before the device finishes).
* ``trace``: context manager around ``jax.profiler`` producing a trace
  directory (TensorBoard / Perfetto).
* ``PassMeter``: running rays/s, spp, and per-pass ms; renders the reference's
  one-line console format or structured JSONL.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

import jax


def timed(fn, *args, reps: int = 3, warmup: int = 1):
    """(result, seconds_per_call) with compile excluded."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def trace(log_dir: str = "chiprun_out/jax-trace"):
    """jax.profiler trace around a block (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class PassMeter:
    """Per-pass metrics accumulator; the analog of the reference's
    'Rays per pixel: N  Time per pass: ms' line (CudaTracer.cu:645)."""

    def __init__(self, width: int, height: int, jsonl_path: Optional[str] = None):
        self.width = width
        self.height = height
        self.jsonl_path = jsonl_path
        self.samples = 0
        self.total_time = 0.0

    def record(self, samples_this_pass: int, seconds: float) -> dict:
        self.samples += samples_this_pass
        self.total_time += seconds
        m = {
            "pass_samples": samples_this_pass,
            "samples_per_pixel": self.samples,
            "pass_time_s": seconds,
            "primary_rays_per_s": self.width * self.height * samples_this_pass / seconds,
            "avg_rays_per_s": self.width * self.height * self.samples / self.total_time,
        }
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(m) + "\n")
        return m

    def console_line(self, m: dict) -> str:
        return (f"Rays per pixel: {m['samples_per_pixel']}  "
                f"Time per pass: {m['pass_time_s'] * 1e3:.1f} ms  "
                f"({m['primary_rays_per_s'] / 1e6:.2f} M primary rays/s)")
