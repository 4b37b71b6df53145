#!/usr/bin/env python
"""Regenerate tests/golden/*.npy after a DELIBERATE estimator change.
Run on CPU: JAX_PLATFORMS=cpu python scripts/regen_golden.py"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render.integrator import camera_arrays, render

out_dir = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")
cp = camera_arrays(Camera())
for name in ["cornell_lambert", "cornell", "showcase"]:
    img = render(presets.get_scene(name), cp, 32, 32, 8,
                 42, max_bounces=4, live_cutoff=None)
    path = os.path.join(out_dir, f"{name}_32x32_8spp_4b.npy")
    np.save(path, np.asarray(img))
    print("wrote", path)

# 64x64 CPU references for the GPU suite (tests/test_pallas.py): the fused
# kernel on the card is compared against these CPU jnp-engine renders —
# identical RNG streams, so only cross-platform float noise separates them.
CARD_REFS = [("cornell", 16, 6), ("showcase", 16, 8), ("stress", 8, 6),
            ("mesh_demo", 16, 6), ("point_light_spheres", 16, 6)]
for name, spp, bounces in CARD_REFS:
    img = render(getattr(presets, name)(), cp, 64, 64, spp, 7,
                 max_bounces=bounces, live_cutoff=None)
    path = os.path.join(out_dir, f"cpu_ref_{name}_64x64_{spp}spp_{bounces}b.npy")
    np.save(path, np.asarray(img))
    print("wrote", path)

# physical-estimator goldens: guard the unbiased mode's MIS math (per-lobe
# densities, prev_pdf emission weights) against accidental drift — its
# correctness tests are statistical, so a byte-stable render is the only
# cheap exactness guard. cornell exercises diffuse + mirror; the glass
# showcase adds refraction/absorption paths.
for name in ["cornell", "glass"]:
    img = render(presets.get_scene(name), cp, 32, 32, 8, 42,
                 max_bounces=4, live_cutoff=None, physical=True)
    path = os.path.join(out_dir, f"physical_{name}_32x32_8spp_4b.npy")
    np.save(path, np.asarray(img))
    print("wrote", path)

# physical-estimator CPU reference (tests/test_pallas.py): the fused
# kernel's physical mode on the card vs the CPU jnp engine, same streams
img = render(presets.cornell(), cp, 64, 64, 16, 7, max_bounces=6,
             live_cutoff=None, physical=True)
path = os.path.join(out_dir, "cpu_ref_physical_cornell_64x64_16spp_6b.npy")
np.save(path, np.asarray(img))
print("wrote", path)

# bidirectional-estimator golden: a tiny pinned-value render of the combined MIS estimator so estimator drift in
# either half or the weights is caught per-commit, not per-round. Uses the
# shadowed_caustic preset so light-trace splats carry real weight.
from cuda_path_tracer_ss.render.bidir import render_bidir
img = render_bidir(presets.shadowed_caustic(), cp, 16, 16, 2, 512, 42,
                   max_bounces=3)
path = os.path.join(out_dir, "bidir_shadowed_caustic_16x16_2spp_512p_3b.npy")
np.save(path, np.asarray(img))
print("wrote", path)
