"""Native C++ runtime vs the Python oracles: scene builder must be
bit-identical, image encoders byte-identical."""
import os
import subprocess

import numpy as np
import pytest

from cuda_path_tracer_ss import native
from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.ops import tonemap
from cuda_path_tracer_ss.utils import image as image_io

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="libptnative.so not built (make -C native)")


@pytest.mark.parametrize("preset", ["showcase", "cornell", "cornell_empty",
                                    "glass", "point_lights"])
def test_native_scene_matches_python(preset):
    got = native.build_scene_arrays(preset)
    scene = presets.get_scene(preset)

    sph_py = np.stack([np.asarray(scene.sph_center.x), np.asarray(scene.sph_center.y),
                       np.asarray(scene.sph_center.z), np.asarray(scene.sph_radius)], -1)
    np.testing.assert_array_equal(got["spheres"], sph_py)
    np.testing.assert_array_equal(got["sph_mat"], np.asarray(scene.sph_mat))

    tri_py = np.concatenate([
        np.stack([np.asarray(getattr(scene, f).x), np.asarray(getattr(scene, f).y),
                  np.asarray(getattr(scene, f).z)], -1)
        for f in ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2")
    ], -1)
    np.testing.assert_allclose(got["triangles"], tri_py, atol=2e-6)
    np.testing.assert_array_equal(got["tri_mat"], np.asarray(scene.tri_mat))

    m = scene.materials
    mats_py = np.concatenate([
        np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)
        for v in (m.diffuse, m.specular, m.absorption, m.emission)
    ] + [np.asarray(f)[:, None] for f in
         (m.spec_exp, m.ior, m.diff_avg, m.spec_avg, m.refr_avg, m.roughness)], -1)
    np.testing.assert_array_equal(got["materials"][:, :18], mats_py)
    np.testing.assert_array_equal(got["flags"], np.asarray(m.flags))

    al_py = np.stack([np.asarray(scene.al_power.x), np.asarray(scene.al_power.y),
                      np.asarray(scene.al_power.z)], -1)
    np.testing.assert_array_equal(got["al_power"], al_py)
    np.testing.assert_allclose(got["al_area"], np.asarray(scene.al_area), rtol=1e-6)
    np.testing.assert_array_equal(got["al_tri0"], np.asarray(scene.al_tri0))

    pl_py = np.concatenate([
        np.stack([np.asarray(scene.pl_pos.x), np.asarray(scene.pl_pos.y),
                  np.asarray(scene.pl_pos.z)], -1),
        np.stack([np.asarray(scene.pl_power.x), np.asarray(scene.pl_power.y),
                  np.asarray(scene.pl_power.z)], -1),
    ], -1)
    np.testing.assert_array_equal(got["point_lights"], pl_py)


def test_native_tonemap_matches_python():
    rng = np.random.default_rng(0)
    radiance = rng.uniform(-0.2, 1.4, (16, 16, 3)).astype(np.float32)
    # seed the dark range where the gamma curve is steepest
    radiance[0, :4] = rng.uniform(0, 3e-4, (4, 3)).astype(np.float32)
    got = native.tonemap_u8(radiance)
    want = np.asarray(tonemap.to_uint8(tonemap.tonemap(radiance)))
    np.testing.assert_array_equal(got, want)


def test_native_tonemap_nan_safe():
    radiance = np.array([[[np.nan, -np.inf, np.inf]]], np.float32)
    got = native.tonemap_u8(radiance)
    assert got.tolist() == [[[0, 0, 255]]]


def test_native_tga_matches_python(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    p_native = str(tmp_path / "n.tga")
    p_python = str(tmp_path / "p.tga")
    assert native.write_tga(p_native, img)
    image_io.write_tga(p_python, img)
    assert open(p_native, "rb").read() == open(p_python, "rb").read()
