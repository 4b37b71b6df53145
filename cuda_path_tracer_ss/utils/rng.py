"""Counter-based PRNG shared bit-exactly by the jnp engine and the Pallas
fused kernel.

Replaces the reference's stateful per-pixel cuRAND XORWOW array
(``CudaTracer/CudaTracer.cu:22-29`` and every ``curand_uniform`` call site)
with Threefry-2x32 (13 rounds — the BigCrush-passing minimum per Salmon et
al. SC'11, see ``ROUNDS`` below; ``rounds=20`` reproduces
``jax._src.prng.threefry_2x32`` bitwise, validated in tests). Every uniform
is a pure
function of four int32 counters::

    key     = (seed, flat_pixel_index)
    counter = (sample_index, pair_index)

so draws are stateless, replayable (any path can be re-simulated from the
same counters), *engine-invariant* (the jnp estimator and the
megakernel consume identical streams — per-pixel image parity), and
*sharding-invariant* (a pixel's stream depends only on its flat index and
global sample index, never on the tile/device layout, so any mesh produces
bitwise the same image as a single chip).

Everything here is plain int32 add/xor/shift jnp code, so the same functions
trace on the CPU, the GPU, and inside Pallas kernel bodies.

Pair-index layout (one threefry call yields two uniforms)::

    pair 0                      eye-ray jitter (x, y)        CudaTracer.cu:327
    per bounce b, base = 1 + b * (2 + 2 * num_area_lights):
      base + 0                  (branch select, dir sample a) CudaTracer.cu:211
      base + 1                  (dir sample b, unused)
      base + 2+2i / base + 3+2i area light i: (u1, u2) / (u3, pick)
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

_GOLD = np.int32(0x1BD11BDA)  # Threefry key-schedule parity constant
_M24 = np.int32(0x00FFFFFF)
_INV24 = np.float32(1.0 / 16777216.0)

# Uniform rows consumed per bounce by the estimator: 3 scatter + 4 per area
# light (ops/bsdf.UNIFORMS_PER_SCATTER, ops/shading.UNIFORMS_PER_AREA_LIGHT).
PAIR_EYE = 0


def pairs_per_bounce(num_area_lights: int) -> int:
    return 2 + 2 * num_area_lights


def pair_base(bounce_idx, num_area_lights: int):
    """First pair index of bounce ``bounce_idx`` (int or int32 array)."""
    return 1 + bounce_idx * pairs_per_bounce(num_area_lights)


def _rotl(x, d: int):
    return lax.shift_left(x, np.int32(d)) | lax.shift_right_logical(
        x, np.int32(32 - d))


# Rounds for the renderer's draws. 13 is the BigCrush-passing minimum for
# Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC'11, Table 2); the canonical 20 is safety margin we do not need for
# Monte Carlo sampling, and the RNG runs in every bounce of the hot kernel
# (~8% of render time at 20 rounds). Both engines share this constant, so
# per-pixel parity is unaffected. rounds=20 reproduces jax's own
# threefry_2x32 bitwise (validated in tests/test_utils.py).
ROUNDS = 13

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)  # rotation schedule, period 8


def threefry2x32(k0, k1, x0, x1, rounds: int = ROUNDS):
    """Threefry-2x32 on int32 lanes (wraparound adds), Random123 round
    structure: initial key injection, then key+counter injection after every
    4th mix round. All four operands broadcast elementwise; returns two
    int32 blocks."""
    k0, k1, x0, x1 = (jnp.asarray(v).astype(jnp.int32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _GOLD)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(rounds):
        x0 = x0 + x1
        x1 = _rotl(x1, _ROT[i % 8])
        x1 = x1 ^ x0
        if (i + 1) % 4 == 0:
            blk = (i + 1) // 4
            x0 = x0 + ks[blk % 3]
            x1 = x1 + ks[(blk + 1) % 3] + np.int32(blk)
    return x0, x1


def _u24(bits):
    # 24 mantissa-bit uniform in [0, 1). Mask (not shift) the low 24 bits on
    # the int32 domain: an arithmetic >> would smear the sign bit into
    # negative "uniforms".
    return (bits & _M24).astype(jnp.float32) * _INV24


def uniform_pair(seed, pixel, sample, pair):
    """Two U[0,1) streams for (seed, pixel, sample, pair); elementwise over
    any broadcastable operand shapes."""
    o0, o1 = threefry2x32(seed, pixel, sample, pair)
    return _u24(o0), _u24(o1)


def eye_jitter(seed, pixel_idx, sample_idx):
    """Sub-pixel AA jitter (x, y) for each pixel — the two ``curand_uniform``
    draws of ``computeEyeRay`` (CudaTracer.cu:327-328)."""
    return uniform_pair(seed, pixel_idx, sample_idx, PAIR_EYE)


def bounce_rows(seed, pixel_idx, sample_idx, bounce_idx, num_area_lights: int):
    """The ``[3 + 4 * num_area_lights, N]`` uniform block one bounce consumes,
    rows in the integrator's layout: (branch, dir_a, dir_b) then 4 rows per
    area light (u1, u2, u3, pick)."""
    base = pair_base(bounce_idx, num_area_lights)
    b0, b1 = uniform_pair(seed, pixel_idx, sample_idx, base)
    b2, _ = uniform_pair(seed, pixel_idx, sample_idx, base + 1)
    rows = [b0, b1, b2]
    for i in range(num_area_lights):
        u1, u2 = uniform_pair(seed, pixel_idx, sample_idx, base + 2 + 2 * i)
        u3, up = uniform_pair(seed, pixel_idx, sample_idx, base + 3 + 2 * i)
        rows += [u1, u2, u3, up]
    return jnp.stack(rows)


def seed_for(base_seed, stream: int):
    """Derive an unrelated int32 seed (distinct threefry key word) for an
    auxiliary stream — e.g. inverse-rendering resampling epochs."""
    return jnp.asarray(base_seed, jnp.int32) * np.int32(1000003) + np.int32(stream)
