import numpy as np

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.utils.msvc_rand import MsvcRand


def test_msvc_rand_known_sequence():
    # First values of MSVC CRT rand() from seed 1 — a published constant
    # sequence; the reference's scene determinism rests on it (Scene.cpp:3).
    r = MsvcRand()
    assert [r.rand() for _ in range(5)] == [41, 18467, 6334, 26500, 19169]


def test_showcase_counts():
    # Scene.cpp:25-31: 5 + 15 spheres; mirror box = 6 rects + 2 area lights
    # = 16 triangles; materials 3 + 3 + 6 = 12.
    s = presets.showcase()
    assert s.num_spheres == 20
    assert s.num_triangles == 16
    assert s.materials.flags.shape[0] == 12
    assert s.num_area_lights == 2
    assert s.num_point_lights == 0


def test_showcase_sphere_positions_in_range():
    s = presets.showcase()
    x = np.asarray(s.sph_center.x)
    y = np.asarray(s.sph_center.y)
    z = np.asarray(s.sph_center.z)
    r = np.asarray(s.sph_radius)
    assert np.all((x >= -2.5) & (x <= 2.5))
    assert np.all((y >= -2.5) & (y <= 2.5))
    assert np.all((z >= -9.0) & (z <= -2.0))
    assert np.all((r >= 0.2) & (r <= 1.2))


def test_cornell_box_geometry():
    s = presets.cornell_empty()
    # 5 walls + mirror + light = 7 rects = 14 triangles, one area light.
    assert s.num_triangles == 14
    assert s.num_area_lights == 1
    # Area of the 2.5-scaled light rect is 6.25 (Scene.cpp:40-55).
    np.testing.assert_allclose(np.asarray(s.al_area), [6.25], rtol=1e-5)
    # Floor normal points up: first rect is the floor (rotated -90 about x).
    np.testing.assert_allclose(
        [float(s.tri_n0.x[0]), float(s.tri_n0.y[0]), float(s.tri_n0.z[0])],
        [0.0, 1.0, 0.0], atol=1e-6)


def test_mirror_box_flags():
    s = presets.showcase()
    flags = np.asarray(s.materials.flags)
    # mirror material (index 3+3+4=10) has PURE_REFLECTION
    assert flags[10] == 0x01
    # Cook-Torrance sphere materials (0..2) carry the 0x03 flag
    assert all(flags[i] == 0x03 for i in range(3))


def test_light_power_values():
    s = presets.showcase()
    p = np.stack([np.asarray(s.al_power.x), np.asarray(s.al_power.y),
                  np.asarray(s.al_power.z)], -1)
    np.testing.assert_allclose(p, [[100, 400, 400], [400 / 3, 0, 400 / 3]], rtol=1e-5)
