#!/usr/bin/env python
"""Fused Triton kernel vs the jnp engine under XLA, on the GPU.

For each case (Cornell 800^2 x 8 bounces, the reference showcase 512^2 x 15
bounces) this measures, per engine: cold compile time, the compiled
program's ``memory_analysis()``, warmed primary rays/s (timed with
``block_until_ready``), and the per-pixel parity of the two engines on the
same RNG streams. ``--tiles``/``--warps`` sweep the kernel's rays per
program and warps per program (``megakernel.TILE``/``NUM_WARPS``),
``--unroll-limits`` the primitive count up to which its sweeps unroll
(``megakernel.UNROLL_LIMIT``);
``--jnp-unroll`` also times the jnp engine with its primitive sweeps
unrolled (``ops/intersect.UNROLL_MAX_PRIMS``).

Every result is one JSON line on stdout (and in ``--out``) carrying the
device's platform, kind and the card's name and power limit. Requires a
GPU: it refuses to run anywhere else.

    python scripts/bench_engines.py --out chiprun_out/engines.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

CASES = {
    "cornell_800": ("cornell", 800, 800, 8),
    "showcase_512": ("showcase", 512, 512, 15),
}


def card_info() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 — reported, not fatal
        return f"nvidia-smi unavailable ({type(e).__name__})"


def parity(a, b):
    """The fused-vs-reference rule: per pixel with an outlier allowance,
    channel means, correlation over the agreeing pixels."""
    close = np.isclose(a, b, rtol=0.02, atol=2e-3).all(axis=-1)
    mean_rel = np.abs(a.mean((0, 1)) - b.mean((0, 1))) / np.maximum(
        np.abs(b.mean((0, 1))), 1e-12)
    corr = float(np.corrcoef(a[close].ravel(), b[close].ravel())[0, 1])
    return {"close_frac": float(close.mean()),
            "mean_rel_err": float(mean_rel.max()), "corr": corr,
            "finite": bool(np.isfinite(a).all()),
            "ok": bool(close.mean() >= 0.98 and mean_rel.max() <= 0.02
                       and corr > 0.999 and np.isfinite(a).all())}


def compile_timed(fn, *args):
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    cold = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = None if ma is None else {
        k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}
    return compiled, cold, mem


def time_calls(compiled, args_for, reps):
    jax.block_until_ready(compiled(*args_for(0)))        # warm
    t0 = time.perf_counter()
    for i in range(reps):
        out = compiled(*args_for(i + 1))
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--spp-fused", type=int, default=256)
    ap.add_argument("--spp-jnp", type=int, default=8)
    ap.add_argument("--parity-spp", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiles", default="64")
    ap.add_argument("--warps", default="2",
                    help="comma list; paired with --tiles when as long")
    ap.add_argument("--unroll-limits", default=None,
                    help="comma list of megakernel.UNROLL_LIMIT values")
    ap.add_argument("--jnp-unroll", default="0",
                    help="comma list of ops/intersect.UNROLL_MAX_PRIMS values")
    ap.add_argument("--skip-jnp", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_engines.py needs a GPU; JAX found {dev.platform!r}")
    jax.config.update("jax_default_matmul_precision", "highest")

    from cuda_path_tracer_ss.models import presets
    from cuda_path_tracer_ss.models.camera import Camera
    from cuda_path_tracer_ss.ops import intersect
    from cuda_path_tracer_ss.ops.pallas import megakernel
    from cuda_path_tracer_ss.ops.pallas.megakernel import (
        pack_scene, render_megakernel)
    from cuda_path_tracer_ss.render.integrator import camera_arrays, render

    base = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()}
    out_f = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({**base, **rec})
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    cp = camera_arrays(Camera())
    tiles = [int(t) for t in args.tiles.split(",")]
    warps = [int(w) for w in args.warps.split(",")]
    # equal-length lists pair up (tile i with warps i); otherwise a grid
    configs = (list(zip(tiles, warps)) if len(tiles) == len(warps)
               else [(t, nw) for t in tiles for nw in warps])
    limits = ([int(u) for u in args.unroll_limits.split(",")]
              if args.unroll_limits else [megakernel.UNROLL_LIMIT])
    defaults = (megakernel.UNROLL_LIMIT, megakernel.TILE,
                megakernel.NUM_WARPS)
    for case in args.cases.split(","):
        name, w, h, bounces = CASES[case]
        scene = getattr(presets, name)()
        packed = jax.block_until_ready(pack_scene(scene))
        fused_par = None
        for limit, (tile, nw) in [(u, c) for u in limits for c in configs]:
            # the kernel's constants are read at trace time: drop cached
            # traces
            megakernel.UNROLL_LIMIT = limit
            megakernel.TILE, megakernel.NUM_WARPS = tile, nw
            jax.clear_caches()

            def fused(pk, cp, seed, spp, offset):
                return render_megakernel(pk, cp, seed, w, h, spp,
                                         max_bounces=bounces,
                                         sample_offset=offset)
            a0 = (packed, cp, jnp.int32(7), jnp.int32(args.spp_fused),
                  jnp.int32(0))
            comp, cold, mem = compile_timed(fused, *a0)
            dt = time_calls(comp, lambda i: (
                packed, cp, jnp.int32(7), jnp.int32(args.spp_fused),
                jnp.int32(i * args.spp_fused)), args.reps)
            if fused_par is None:
                fused_par = np.asarray(comp(
                    packed, cp, jnp.int32(7), jnp.int32(args.parity_spp),
                    jnp.int32(0)))
            emit({"case": case, "engine": "fused", "tile": tile,
                  "num_warps": nw, "unroll_limit": limit,
                  "spp": args.spp_fused,
                  "compile_s": cold, "call_s": dt,
                  "rays_per_s": w * h * args.spp_fused / dt,
                  "memory": mem})
        (megakernel.UNROLL_LIMIT, megakernel.TILE,
         megakernel.NUM_WARPS) = defaults
        jax.clear_caches()
        if args.skip_jnp:
            continue
        for unroll in [int(u) for u in args.jnp_unroll.split(",")]:
            # read at trace time: drop the jitted render's cached traces
            intersect.UNROLL_MAX_PRIMS = unroll
            jax.clear_caches()

            def ref(scene, cp, seed, offset, spp):
                return render(scene, cp, w, h, spp, seed,
                              max_bounces=bounces, sample_offset=offset)
            spp = args.spp_jnp
            comp, cold, mem = compile_timed(
                lambda s, c, k, o: ref(s, c, k, o, spp), scene, cp,
                jnp.int32(7), jnp.int32(0))
            dt = time_calls(comp, lambda i: (scene, cp, jnp.int32(7),
                                             jnp.int32(i * spp)), args.reps)
            emit({"case": case, "engine": "jnp", "unroll_max_prims": unroll,
                  "spp": spp, "compile_s": cold, "call_s": dt,
                  "rays_per_s": w * h * spp / dt, "memory": mem})
        intersect.UNROLL_MAX_PRIMS = 0
        jax.clear_caches()
        want = np.asarray(jax.jit(
            lambda s, c: render(s, c, w, h, args.parity_spp, jnp.int32(7),
                                max_bounces=bounces, live_cutoff=None))(
                                    scene, cp))
        emit({"case": case, "parity_spp": args.parity_spp,
              "parity": parity(fused_par, want)})


if __name__ == "__main__":
    main()
