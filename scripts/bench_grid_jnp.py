"""jnp-engine grid-vs-linear benchmark on the live backend.

The uniform grid lives in the jnp gather engine: each ray walks its
own cells via vectorized gathers (ops/grid.py DDA), so per-ray work tracks
cells-on-ray x occupancy instead of O(prims). This script measures that on a
primitive-heavy stress scene, at shapes small enough that the LINEAR
baseline's [rays, prims] broadcast does not blow device memory.

Usage: python scripts/bench_grid_jnp.py [num_spheres] [width] [spp]
"""
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from cuda_path_tracer_ss.models import presets            # noqa: E402
from cuda_path_tracer_ss.models.camera import Camera      # noqa: E402
from cuda_path_tracer_ss.ops.grid import build_grid       # noqa: E402
from cuda_path_tracer_ss.render.integrator import (       # noqa: E402
    camera_arrays, render)

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
W = H = int(sys.argv[2]) if len(sys.argv) > 2 else 128
SPP = int(sys.argv[3]) if len(sys.argv) > 3 else 4
BOUNCES = 6
REPEATS = 3

scene = presets.stress(N)
print(f"stress({N}): {scene.num_spheres} spheres, "
      f"{scene.num_triangles} triangles, backend={jax.default_backend()}, "
      f"{W}x{H}x{SPP}spp x{BOUNCES}b")
cp = camera_arrays(Camera())
grid = build_grid(scene)
print("grid res", grid.res, "Ks", grid.sph_list.shape[1],
      "Kt", grid.tri_list.shape[1])


def bench(label, g, live_cutoff):
    def run(k):
        return render(scene, cp, W, H, SPP, jnp.int32(0),
                      max_bounces=BOUNCES, live_cutoff=live_cutoff,
                      sample_offset=k * SPP, grid=g)

    t0 = time.perf_counter()
    img = jax.block_until_ready(run(0))
    compile_s = time.perf_counter() - t0
    assert np.isfinite(float(img.sum()))
    t0 = time.perf_counter()
    for i in range(1, REPEATS + 1):
        out = run(i)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    rate = W * H * SPP * REPEATS / dt
    print(f"{label:22s} compile {compile_s:7.1f}s  "
          f"{dt / REPEATS * 1e3:8.2f} ms/render  {rate / 1e6:8.2f} M rays/s")
    return np.asarray(img), rate


# live_cutoff=1 -> while-loop wavefront driver + while-loop (forward-only)
# DDA march; live_cutoff=None -> scan driver + scan DDA (differentiable)
img_lin, rate_lin = bench("linear while", None, 1)
img_grid, rate_grid = bench("grid while", grid, 1)
img_ling, rate_ling = bench("linear scan (diff)", None, None)
img_gridg, rate_gridg = bench("grid scan (diff)", grid, None)

d = np.abs(img_lin - img_grid)
print(f"parity(while): max abs diff {d.max():.3e}  mean {d.mean():.3e}")
d2 = np.abs(img_ling - img_gridg)
print(f"parity(scan):  max abs diff {d2.max():.3e}  mean {d2.mean():.3e}")
print(f"speedup: while {rate_grid / rate_lin:.2f}x  "
      f"scan {rate_gridg / rate_ling:.2f}x")
