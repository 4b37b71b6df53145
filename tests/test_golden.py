"""Golden-image regression — SURVEY §4 item 3: fixed threefry seed renders of
the preset scenes must stay byte-stable on CPU. Regenerate deliberately with
scripts/regen_golden.py if the estimator's semantics change on purpose."""
import os

import jax
import numpy as np
import pytest

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.render.integrator import camera_arrays, render

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CASES = ["cornell_lambert", "cornell", "showcase"]


@pytest.mark.parametrize("name", CASES)
def test_golden_image(name):
    path = os.path.join(GOLDEN_DIR, f"{name}_32x32_8spp_4b.npy")
    want = np.load(path)
    img = render(presets.get_scene(name), camera_arrays(Camera()), 32, 32, 8,
                 42, max_bounces=4, live_cutoff=None)
    # same platform + same seed -> identical float32 output
    np.testing.assert_array_equal(np.asarray(img), want)


@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_golden_image_physical(name):
    """The unbiased estimator's exactness guard: its correctness tests are
    statistical (estimator agreement, quadrature), so byte-stable renders
    are what catch accidental drift in the MIS math."""
    path = os.path.join(GOLDEN_DIR, f"physical_{name}_32x32_8spp_4b.npy")
    want = np.load(path)
    img = render(presets.get_scene(name), camera_arrays(Camera()), 32, 32, 8,
                 42, max_bounces=4, live_cutoff=None, physical=True)
    np.testing.assert_array_equal(np.asarray(img), want)


def test_golden_image_bidir():
    """Round 5 (VERDICT r4 weak #5): a pinned-value render of the
    BIDIRECTIONAL estimator in the fast gate — the statistical agreement
    tests are all slow-tier, so without this a drift in either half's
    densities or the MIS weights would only surface at round snapshots.
    shadowed_caustic gives the light-trace splats real weight."""
    from cuda_path_tracer_ss.render.bidir import render_bidir
    path = os.path.join(GOLDEN_DIR,
                        "bidir_shadowed_caustic_16x16_2spp_512p_3b.npy")
    want = np.load(path)
    img = render_bidir(presets.shadowed_caustic(), camera_arrays(Camera()),
                       16, 16, 2, 512, 42, max_bounces=3)
    np.testing.assert_array_equal(np.asarray(img), want)
    assert want.mean() > 1e-4  # the caustic is in frame, not a black image
