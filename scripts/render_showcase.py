#!/usr/bin/env python
"""Produce the showcase renders (the analog of the reference's
CudaTracer/renders/): each preset at 512x512, 2000 spp, 15 bounces — the
reference's showcase quality (README.md:32) — via the fused Pallas-Triton
kernel on a GPU. Writes renders/<name>.png.

Usage: python scripts/render_showcase.py [preset ...]"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render.integrator import camera_arrays
from cuda_path_tracer_ss.ops.pallas.megakernel import pack_scene, render_megakernel
from cuda_path_tracer_ss import native
from cuda_path_tracer_ss.utils.image import write_png

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "renders")
SIZE = 512
SPP = 2000
BOUNCES = 15
CHUNK = 250  # spp per kernel call


def main():
    os.makedirs(OUT, exist_ok=True)
    cp = camera_arrays(Camera())
    for name in sys.argv[1:] or ["showcase", "cornell", "glass"]:
        packed = jax.block_until_ready(pack_scene(presets.get_scene(name)))
        t0 = time.time()
        acc = np.zeros((SIZE, SIZE, 3), np.float64)
        done = 0
        while done < SPP:
            n = min(CHUNK, SPP - done)
            # sample_clamp=1.0 reproduces the reference's per-frame [0,1]
            # clamp (its firefly suppression, CudaTracer.cu:72)
            img = render_megakernel(packed, cp, 1000, SIZE, SIZE, n,
                                    BOUNCES, sample_clamp=1.0,
                                    sample_offset=done)
            acc += np.asarray(img, np.float64) * n
            done += n
            print(f"{name}: {done}/{SPP} spp  ({time.time()-t0:.1f}s)",
                  end="\r", flush=True)
        radiance = (acc / SPP).astype(np.float32)
        img_u8 = native.tonemap_u8(radiance)
        path = os.path.join(OUT, f"{name}.png")
        write_png(path, img_u8)
        print(f"\nwrote {path} in {time.time()-t0:.1f}s "
              f"({SIZE*SIZE*SPP/(time.time()-t0)/1e6:.0f} M rays/s)")


if __name__ == "__main__":
    main()
