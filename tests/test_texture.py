"""Color/normal mapping (ops/texture.py) — the last feature the reference
slated (its README.md:35) but never built. Both engines since round 4:
the megakernel's texture block is parity-tested here against the jnp
engine. Round 5: textured scenes TRAIN on the fast engine too (the replay
VJP's texel scatter; linear mode) — gradient parity, gating, and the
sharded-training certification live here."""
import numpy as np
import pytest

import jax.numpy as jnp

from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.models.scene import MaterialSpec, SceneBuilder
from cuda_path_tracer_ss.ops.texture import sample_bilinear, sphere_uv
from cuda_path_tracer_ss.ops.vec import Vec3
from cuda_path_tracer_ss.render.integrator import camera_arrays, render


def _quad_scene(tex=True, nmap=False, sphere=False):
    b = SceneBuilder()
    checker = np.zeros((2, 2, 3), np.float32)
    checker[:, 0] = (1.0, 0.1, 0.1)   # left texel column red
    checker[:, 1] = (0.1, 0.1, 1.0)   # right column blue
    tid = b.add_texture(checker) if tex else -1
    nid = -1
    if nmap:
        nm = np.zeros((2, 2, 3), np.float32)
        nm[..., 0] = 0.85
        nm[..., 1] = 0.5
        nm[..., 2] = 0.9
        nid = b.add_texture(nm)
    m = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.8,
                                    texture=tid, normal_map=nid))
    if sphere:
        b.add_sphere((0.0, 0.0, -4.0), 1.6, m)
    else:
        v = [(-2, -2, -4), (2, -2, -4), (2, 2, -4), (-2, 2, -4)]
        uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        n = (0, 0, 1)
        b.add_triangle(v[0], v[1], v[2], n, n, n, m,
                       uv=(uv[0], uv[1], uv[2]))
        b.add_triangle(v[0], v[2], v[3], n, n, n, m,
                       uv=(uv[0], uv[2], uv[3]))
    b.add_point_light((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
    b.background = np.zeros(3, np.float32)
    return b.build()


def test_bilinear_sampler_exact_values():
    """Texel centers return exact texel values; midpoints blend 50/50;
    wrap-around blends the two edge columns."""
    tex = jnp.asarray(np.arange(12, dtype=np.float32).reshape(1, 2, 2, 3))
    hw = jnp.asarray([[2, 2]], np.int32)
    tid = jnp.zeros((4,), jnp.int32)
    # texel centers: (u,v)=(0.25,0.75)->row0,col0 ; (0.75,0.75)->row0,col1
    u = jnp.asarray([0.25, 0.75, 0.25, 0.5])
    v = jnp.asarray([0.75, 0.75, 0.25, 0.75])
    out = sample_bilinear(tex, hw, tid, u, v)
    got = np.stack([np.asarray(out.x), np.asarray(out.y), np.asarray(out.z)], -1)
    np.testing.assert_allclose(got[0], [0, 1, 2], atol=1e-6)   # top-left
    np.testing.assert_allclose(got[1], [3, 4, 5], atol=1e-6)   # top-right
    np.testing.assert_allclose(got[2], [6, 7, 8], atol=1e-6)   # bottom-left
    np.testing.assert_allclose(got[3], (got[0] + got[1]) / 2, atol=1e-6)


def test_sphere_uv_poles_and_seam():
    n = Vec3(jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray([1.0, -1.0, 0.0]),
             jnp.asarray([0.0, 0.0, 0.0]))
    u, v = sphere_uv(n)
    np.testing.assert_allclose(np.asarray(v), [1.0, 0.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(float(u[2]), 0.5, atol=1e-6)  # +x -> u=0.5


def test_color_map_on_quad():
    cp = camera_arrays(Camera())
    img = np.asarray(render(_quad_scene(), cp, 32, 32, 8, 0,
                            max_bounces=2, live_cutoff=None))
    left = img[12:20, 4:12].mean((0, 1))
    right = img[12:20, 20:28].mean((0, 1))
    assert left[0] > 2 * left[2], (left, right)    # red side
    assert right[2] > 2 * right[0], (left, right)  # blue side


def test_color_map_on_sphere_procedural_uv():
    cp = camera_arrays(Camera())
    img = np.asarray(render(_quad_scene(sphere=True), cp, 32, 32, 8, 0,
                            max_bounces=2, live_cutoff=None))
    assert np.isfinite(img).all()
    # camera looks down -z at the sphere: visible normals have n.z > 0, so
    # sphere_uv longitudes span u in (0.5, 1.0) left-to-right as
    # u = 0.5 + atan2(n.z, n.x)/2pi: the center of the disk sits at
    # u ~ 0.75 (pure column-1 blue texel) while the left limb approaches
    # u -> 1.0, wrapping toward the red column-0 texel
    left_limb = img[14:18, 10:12].mean((0, 1))
    center = img[14:18, 15:18].mean((0, 1))
    assert (left_limb[0] - left_limb[2]) > (center[0] - center[2]) + 0.005, (
        left_limb, center)
    assert center[2] > center[0]  # center of the disk is the blue texel


def test_normal_map_changes_shading_finite():
    cp = camera_arrays(Camera())
    base = np.asarray(render(_quad_scene(tex=False), cp, 32, 32, 8, 0,
                             max_bounces=2, live_cutoff=None))
    nm = np.asarray(render(_quad_scene(tex=False, nmap=True), cp, 32, 32,
                           8, 0, max_bounces=2, live_cutoff=None))
    assert np.isfinite(nm).all()
    assert np.abs(nm - base).max() > 0.01
    # constant tangent-tilt on a flat quad: brightness shifts the SAME
    # direction everywhere lit (the frame is UV-aligned, +x here)
    delta = (nm - base)[10:22, 10:22].mean()
    assert abs(delta) > 1e-4


@pytest.mark.slow  # 22 s; the 7 s OBJ textured-mesh megakernel parity
# test keeps textured cross-engine coverage in the fast gate
def test_textured_megakernel_matches_jnp_per_pixel():
    """The fused kernel applies color AND normal maps itself — per-lane
    texel gathers — and must match the jnp engine per pixel (identical
    streams, mirrored apply_maps arithmetic incl. the shared polynomial
    atan2/asin)."""
    from cuda_path_tracer_ss.ops.pallas.megakernel import (
        pack_scene, render_megakernel)
    cp = camera_arrays(Camera())
    for scene in (_quad_scene(), _quad_scene(sphere=True),
                  _quad_scene(nmap=True)):
        jn = np.asarray(render(scene, cp, 16, 16, 2, 0, max_bounces=2,
                               live_cutoff=None))
        mk = np.asarray(render_megakernel(pack_scene(scene), cp, 0, 16, 16,
                                          2, max_bounces=2, interpret=True))
        np.testing.assert_allclose(mk, jn, rtol=0, atol=1e-5)


@pytest.mark.slow
def test_textured_preset_megakernel_parity():
    from cuda_path_tracer_ss.models import presets
    from cuda_path_tracer_ss.ops.pallas.megakernel import (
        pack_scene, render_megakernel)
    scene = presets.textured()
    cp = camera_arrays(Camera())
    jn = np.asarray(render(scene, cp, 24, 24, 2, 0, max_bounces=3,
                           live_cutoff=None))
    mk = np.asarray(render_megakernel(pack_scene(scene), cp, 0, 24, 24, 2,
                                      max_bounces=3, interpret=True))
    np.testing.assert_allclose(mk, jn, rtol=0, atol=1e-5)


def test_untextured_scene_is_unchanged():
    """num_textures == 0 bypasses apply_maps entirely — bit-identical to
    the pre-texture renderer (golden tests guard this globally; this is
    the targeted check that the bypass branch exists)."""
    from cuda_path_tracer_ss.models import presets
    scene = presets.cornell()
    assert scene.num_textures == 0
    cp = camera_arrays(Camera())
    img = np.asarray(render(scene, cp, 8, 8, 1, 0, max_bounces=2,
                            live_cutoff=None))
    assert np.isfinite(img).all()


def test_obj_vt_and_map_kd_roundtrip(tmp_path):
    """OBJ vt records + MTL map_Kd: the loaded quad renders with the PNG's
    colors on the right sides."""
    from cuda_path_tracer_ss.utils.image import write_png
    from cuda_path_tracer_ss.utils.obj import add_obj_with_mtl

    teximg = np.zeros((2, 2, 3), np.uint8)
    teximg[:, 0] = (255, 20, 20)
    teximg[:, 1] = (20, 20, 255)
    write_png(str(tmp_path / "skin.png"), teximg, bottom_up=False)
    (tmp_path / "m.mtl").write_text(
        "newmtl skin\nKd 1 1 1\nmap_Kd skin.png\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v -2 -2 -4\nv 2 -2 -4\nv 2 2 -4\nv -2 2 -4\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl skin\nf 1/1 2/2 3/3 4/4\n")
    b = SceneBuilder()
    fb = b.add_material(MaterialSpec(diffuse=(0.5, 0.5, 0.5), diff_avg=0.5))
    count, mmap = add_obj_with_mtl(b, str(tmp_path / "q.obj"), fb)
    assert count == 2 and "skin" in mmap
    b.add_point_light((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
    b.background = np.zeros(3, np.float32)
    scene = b.build()
    assert scene.num_textures == 1
    cp = camera_arrays(Camera())
    img = np.asarray(render(scene, cp, 32, 32, 8, 0, max_bounces=2,
                            live_cutoff=None))
    left = img[12:20, 4:12].mean((0, 1))
    right = img[12:20, 20:28].mean((0, 1))
    assert left[0] > 2 * left[2] and right[2] > 2 * right[0]


@pytest.mark.slow
def test_inverse_recovers_texture_content():
    """Texture TEXELS are trainable: starting from gray, gradient descent
    on the image loss recovers the checker's red/blue split — inverse
    texture painting, a capability far beyond the reference."""
    from cuda_path_tracer_ss.render import inverse

    target_scene = _quad_scene()
    cp = camera_arrays(Camera())
    target = render(target_scene, cp, 24, 24, 8, 0, max_bounces=2,
                    live_cutoff=None)
    start = target_scene.replace(
        textures=jnp.full_like(target_scene.textures, 0.5))
    recovered, params, losses = inverse.invert(
        start, cp, target, ["textures"], 24, 24, spp=8, steps=60, lr=0.1,
        max_bounces=2, seed=0)
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    tex = np.asarray(params["textures"])[0]
    assert tex[:, 0, 0].mean() > tex[:, 0, 2].mean() + 0.2   # left red
    assert tex[:, 1, 2].mean() > tex[:, 1, 0].mean() + 0.2   # right blue


def test_obj_textured_mesh_on_megakernel(tmp_path):
    """Bring-your-own textured mesh on the fused kernel: an OBJ quad with
    vt records + map_Kd renders per-pixel identical to the jnp engine
    through the kernel's texture block (interpret mode)."""
    from cuda_path_tracer_ss.models.scene import SceneBuilder
    from cuda_path_tracer_ss.ops.pallas.megakernel import (
        pack_scene, render_megakernel)
    from cuda_path_tracer_ss.utils.image import write_png
    from cuda_path_tracer_ss.utils.obj import add_obj_with_mtl

    teximg = np.zeros((2, 2, 3), np.uint8)
    teximg[:, 0] = (255, 20, 20)
    teximg[:, 1] = (20, 20, 255)
    write_png(str(tmp_path / "skin.png"), teximg, bottom_up=False)
    (tmp_path / "m.mtl").write_text(
        "newmtl skin\nKd 1 1 1\nmap_Kd skin.png\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\n"
        "v -2 -2 -4\nv 2 -2 -4\nv 2 2 -4\nv -2 2 -4\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl skin\nf 1/1 2/2 3/3 4/4\n")
    b = SceneBuilder()
    fb = b.add_material(MaterialSpec(diffuse=(0.5, 0.5, 0.5), diff_avg=0.5))
    add_obj_with_mtl(b, str(tmp_path / "q.obj"), fb)
    b.add_point_light((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
    b.background = np.zeros(3, np.float32)
    scene = b.build()
    cp = camera_arrays(Camera())
    jn = np.asarray(render(scene, cp, 16, 16, 2, 0, max_bounces=2,
                           live_cutoff=None))
    mk = np.asarray(render_megakernel(pack_scene(scene), cp, 0, 16, 16, 2,
                                      max_bounces=2, interpret=True))
    np.testing.assert_allclose(mk, jn, rtol=0, atol=1e-5)
    # and the texture actually showed up (left red, right blue)
    assert jn[6:10, 2:6, 0].mean() > 2 * jn[6:10, 2:6, 2].mean()


