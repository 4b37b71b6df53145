"""Accumulator/tonemap tests — including the reference's integer-accumulation
compat mode (writeToPixelsKernel, CudaTracer.cu:63-104)."""
import numpy as np
import jax.numpy as jnp

from cuda_path_tracer_ss.ops import tonemap


def test_tonemap_clamps_and_gammas():
    img = jnp.asarray([[-0.5, 0.0, 0.25], [1.0, 2.0, 0.5]], jnp.float32)
    out = np.asarray(tonemap.tonemap(img))
    assert out[0, 0] == 0.0
    assert out[1, 0] == 1.0 and out[1, 1] == 1.0
    np.testing.assert_allclose(out[0, 2], 0.25 ** (1 / 2.2), rtol=1e-6)


def test_to_uint8_rounding():
    # 255*v + 0.5 truncation, as CudaTracer.cu:83-85
    vals = jnp.asarray([0.0, 1.0 / 255.0, 0.5, 1.0])
    out = np.asarray(tonemap.to_uint8(vals))
    assert out.tolist() == [0, 1, 128, 255]


def test_compat_integer_accumulation_matches_reference_recurrence():
    # Simulate 3 frames of the reference pipeline on one pixel and check the
    # quantize->accumulate->average ordering.
    rng = np.random.default_rng(0)
    samples = rng.uniform(0, 1.2, (3, 1, 3)).astype(np.float32)

    total = jnp.zeros((1, 3), jnp.uint32)
    for s in samples:
        total = tonemap.compat_accumulate(total, jnp.asarray(s))

    # manual reference recurrence
    want_total = np.zeros((1, 3), np.uint32)
    for s in samples:
        disp = np.clip(s, 0, 1) ** (1 / 2.2)
        q = np.clip(255 * disp + 0.5, 0, 255).astype(np.uint32)
        want_total += q
    np.testing.assert_array_equal(np.asarray(total), want_total)

    shown = np.asarray(tonemap.compat_display(total, 3))
    want_shown = np.clip(want_total.astype(np.float32) / 3 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(shown, want_shown)


def test_compat_display_bounds():
    total = jnp.asarray([[255 * 10, 0, 128 * 10]], jnp.uint32)
    out = np.asarray(tonemap.compat_display(total, 10))
    assert out.tolist() == [[255, 0, 128]]
