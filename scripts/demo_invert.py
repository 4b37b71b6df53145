#!/usr/bin/env python
"""Inverse-rendering demo (BASELINE config 4): perturb the Cornell scene's
albedos, recover them by pixel-gradient descent, and write target / initial /
recovered images to renders/invert_*.png. (Albedo only: jointly optimizing
albedo and light power is ambiguous — the image constrains their product.)"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render import inverse
from cuda_path_tracer_ss.render.integrator import camera_arrays, render
from cuda_path_tracer_ss import native
from cuda_path_tracer_ss.utils.image import write_png

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "renders")
SIZE = int(os.environ.get("INVERT_SIZE", "96"))
SPP, BOUNCES, STEPS = 4, 3, 200


def save(name, radiance):
    write_png(os.path.join(OUT, name), native.tonemap_u8(np.asarray(radiance)))


def main():
    os.makedirs(OUT, exist_ok=True)
    scene_true = presets.cornell_lambert()
    cp = camera_arrays(Camera())
    key = 7  # counter-RNG seed
    # albedo only: jointly optimizing albedo and light power is ambiguous
    # (their product is what the image constrains)
    fields = ["materials.diffuse"]

    target = render(scene_true, cp, SIZE, SIZE, SPP, key,
                    max_bounces=BOUNCES, live_cutoff=None)
    save("invert_target.png", target)

    params_true = inverse.extract_params(scene_true, fields)
    perturbed = {
        "materials.diffuse": jnp.clip(
            params_true["materials.diffuse"] + jnp.asarray([0.4, -0.3, 0.25]),
            0.05, 1.0),
    }
    scene0 = inverse.merge_params(scene_true, perturbed)
    save("invert_initial.png",
         render(scene0, cp, SIZE, SIZE, SPP, key, max_bounces=BOUNCES,
                live_cutoff=None))

    def cb(step, val, params):
        if step % 20 == 0:
            print(f"step {step:4d}  loss {val:.3e}", flush=True)

    recovered, params, losses = inverse.invert(
        scene0, cp, target, fields, SIZE, SIZE, spp=SPP, steps=STEPS,
        lr=0.05, seed=7, max_bounces=BOUNCES, callback=cb)
    save("invert_recovered.png",
         render(recovered, cp, SIZE, SIZE, SPP, key, max_bounces=BOUNCES,
                live_cutoff=None))

    err_d = np.abs(np.asarray(params["materials.diffuse"])
                   - np.asarray(params_true["materials.diffuse"]))
    print(f"final loss {losses[-1]:.3e}; "
          f"median albedo err {np.median(err_d.max(-1)):.4f}")


if __name__ == "__main__":
    main()
