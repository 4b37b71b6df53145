"""OBJ loading tests (a capability the reference only slated, README.md:30)."""
import numpy as np
import jax

from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.models.scene import MaterialSpec, SceneBuilder, translate, scale
from cuda_path_tracer_ss.render.integrator import camera_arrays, render
from cuda_path_tracer_ss.utils.obj import add_obj_mesh, parse_obj

CUBE = """
# unit cube
v -0.5 -0.5 -0.5
v  0.5 -0.5 -0.5
v  0.5  0.5 -0.5
v -0.5  0.5 -0.5
v -0.5 -0.5  0.5
v  0.5 -0.5  0.5
v  0.5  0.5  0.5
v -0.5  0.5  0.5
f 1 4 3 2
f 5 6 7 8
f 1 2 6 5
f 8 7 3 4
f 3 7 6 2
f 8 4 1 5
"""

TRI_WITH_NORMALS = """
v 0 0 0
v 1 0 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1
"""


def test_parse_quad_cube_fan_triangulates():
    v, f, n = parse_obj(CUBE)
    assert v.shape == (8, 3)
    assert f.shape == (12, 3)       # 6 quads -> 12 triangles
    assert n.shape == (12, 3, 3)
    lens = np.linalg.norm(n, axis=-1)
    np.testing.assert_allclose(lens, 1.0, rtol=1e-5)


def test_explicit_normals_used():
    v, f, n = parse_obj(TRI_WITH_NORMALS)
    np.testing.assert_array_equal(f, [[0, 1, 2]])
    np.testing.assert_allclose(n[0], [[0, 0, 1]] * 3)


def test_smooth_normals_point_outward_on_cube():
    v, f, n = parse_obj(CUBE)
    # smooth vertex normals on a cube point along the corner diagonals
    for tri, tri_n in zip(f, n):
        for vi, vn in zip(tri, tri_n):
            outward = v[vi] / np.linalg.norm(v[vi])
            assert np.dot(vn, outward) > 0.9


def test_negative_indices():
    v, f, n = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    np.testing.assert_array_equal(f, [[0, 1, 2]])


def test_negative_indices_interleaved():
    # OBJ spec: negative indices are relative to the vertex count at the
    # face statement, not end-of-file.
    text = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
            "v 5 0 0\nv 6 0 0\nv 5 1 0\nf -3 -2 -1\n")
    v, f, n = parse_obj(text)
    np.testing.assert_array_equal(f, [[0, 1, 2], [3, 4, 5]])


def test_obj_mesh_renders():
    # emissive cube in front of the camera -> bright pixels at the center
    b = SceneBuilder()
    m = b.add_material(MaterialSpec(emission=(1.0, 0.5, 0.25)))
    n_tris = add_obj_mesh(b, CUBE, m,
                          transform=translate((0, 0, -3)) @ scale((2, 2, 2)),
                          from_text=True)
    assert n_tris == 12
    scene = b.build()
    img = np.asarray(render(scene, camera_arrays(Camera()), 16, 16, 1,
                            0, max_bounces=2,
                            live_cutoff=None))
    center = img[8, 8]
    np.testing.assert_allclose(center, [1.0, 0.5, 0.25], atol=1e-5)
    assert img[0, 0].max() == 0.0   # corners miss the cube -> background


MTL_LIB = """
# two materials
newmtl glow
Ke 2.0 1.5 1.0
Kd 0.1 0.1 0.1

newmtl redwall
Kd 0.8 0.1 0.1
Ks 0.2 0.2 0.2
Ns 50
"""

TWO_QUADS = """
mtllib demo.mtl
v -1 -1 -3
v  0 -1 -3
v  0  1 -3
v -1  1 -3
v  0.2 -1 -3
v  1.2 -1 -3
v  1.2  1 -3
v  0.2  1 -3
usemtl glow
f 1 2 3 4
usemtl redwall
f 5 6 7 8
"""


def test_parse_mtl_projection():
    """MTL fields project onto the reference's material model (documented
    mapping in utils/obj.py::parse_mtl)."""
    from cuda_path_tracer_ss.utils.obj import parse_mtl

    mats = parse_mtl(MTL_LIB)
    assert set(mats) == {"glow", "redwall"}
    g = mats["glow"]
    assert g.emission == (2.0, 1.5, 1.0)
    np.testing.assert_allclose(g.diff_avg, 0.1)
    r = mats["redwall"]
    assert r.diffuse == (0.8, 0.1, 0.1)
    assert r.spec_exp == 50.0
    np.testing.assert_allclose(r.spec_avg, 0.2)
    # dissolve -> refractive branch
    refr = parse_mtl("newmtl w\nKd 1 1 1\nd 0.25\nNi 1.5\n")["w"]
    np.testing.assert_allclose(refr.refr_avg, 0.75)
    assert refr.ior == 1.5
    # Ns >= 1000 promotes to the perfect-mirror INF convention
    assert parse_mtl("newmtl m\nKs 1 1 1\nNs 1000\n")["m"].spec_exp == float("inf")


def test_add_obj_with_mtl_assigns_materials():
    """usemtl records route faces to the .mtl-derived materials: the glow
    quad emits, the red quad doesn't."""
    from cuda_path_tracer_ss.utils.obj import add_obj_with_mtl

    b = SceneBuilder()
    fallback = b.add_material(MaterialSpec(diffuse=(0.5, 0.5, 0.5),
                                           diff_avg=0.5))
    count, mmap = add_obj_with_mtl(b, TWO_QUADS, fallback,
                                   mtl_source=MTL_LIB, from_text=True)
    assert count == 4 and set(mmap) == {"glow", "redwall"}
    b.background = np.zeros(3, np.float32)
    scene = b.build()
    # the glow material must land on the left quad's triangles
    img = np.asarray(render(scene, camera_arrays(Camera()), 24, 24, 4, 0,
                            max_bounces=2, live_cutoff=None))
    left = img[:, :12].mean(axis=(0, 1))
    right = img[:, 12:].mean(axis=(0, 1))
    assert left[0] > 10 * max(right[0], 1e-6)   # emissive side glows
    assert np.isfinite(img).all()
