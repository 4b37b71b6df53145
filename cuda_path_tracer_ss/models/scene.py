"""Scene data model: SoA pytrees for geometry, materials, and lights.

Behavioral spec: the reference's POD structs and host-side scene assembly
(``CudaTracer/RenderStructs.h:24-121``, ``CudaTracer/Scene.h:5-27``,
``CudaTracer/Scene.cpp:17-371``). The JAX design differs deliberately:

* Everything is a *structure of arrays* of device arrays — sphere centers are
  three ``[S]`` arrays, not an array of structs — so the intersection sweep
  vectorizes over rays with no gathers.
* Primitive/material/light counts are static (they are array shapes), so the
  whole renderer jits once per scene topology.
* Materials carry the same parameterization as the reference
  (``RenderStructs.h:80-107``): diffuse/specular/absorption/emission colors,
  specular exponent, IOR, branch weights diff/spec/refr, roughness, flags.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.vec import Vec3

# Material flag bits — mirrors ``RenderStructs.h:77-78``. Note the reference
# defines COOK_TORRANCE as 0x03 (it *includes* the pure-reflection bit), so a
# pure-reflection material also takes the Cook-Torrance sampling path with
# roughness 0 (== a perfect mirror). We reproduce that exact quirk.
MAT_FLAG_PURE_REFLECTION = 0x01
MAT_FLAG_COOK_TORRANCE = 0x03


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table; all fields shape ``[M]`` (colors are Vec3 of [M])."""

    diffuse: Vec3
    specular: Vec3
    absorption: Vec3
    emission: Vec3
    spec_exp: jnp.ndarray
    ior: jnp.ndarray
    diff_avg: jnp.ndarray
    spec_avg: jnp.ndarray
    refr_avg: jnp.ndarray
    roughness: jnp.ndarray
    flags: jnp.ndarray  # int32
    # Color/normal mapping (a feature the reference slated, README.md:35,
    # but never built): indices into Scene.textures, -1 = unmapped. The
    # color map modulates the diffuse albedo at the hit UV; the normal map
    # perturbs the shading normal in the UV tangent frame (ops/texture.py).
    tex_id: jnp.ndarray   # int32
    nmap_id: jnp.ndarray  # int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-resident scene. Counts are shapes, hence static under jit."""

    # Spheres: [S]
    sph_center: Vec3
    sph_radius: jnp.ndarray
    sph_mat: jnp.ndarray  # int32

    # Triangles: [T]
    tri_v0: Vec3
    tri_v1: Vec3
    tri_v2: Vec3
    tri_n0: Vec3
    tri_n1: Vec3
    tri_n2: Vec3
    tri_mat: jnp.ndarray  # int32
    # Per-corner texture coordinates, [T, 2] (zeros when the triangle was
    # built without UVs). Spheres use a procedural spherical parameterization
    # instead (ops/texture.py::sphere_uv).
    tri_uv0: jnp.ndarray
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray

    materials: Materials

    # Texture atlas: [K, TH, TW, 3] float32, padded to the largest image;
    # tex_hw [K, 2] carries each texture's true (height, width). K is a
    # static shape, so a scene jits once per texture-set topology.
    textures: jnp.ndarray
    tex_hw: jnp.ndarray  # int32

    # Point lights: [Lp]
    pl_pos: Vec3
    pl_power: Vec3

    # Area lights: [La]; each is a pair of triangles (tri0, tri0+1), as in
    # ``RenderStructs.h:66-75`` (numTriangles is always 2, ``Scene.cpp:54``).
    al_power: Vec3
    al_area: jnp.ndarray
    al_tri0: jnp.ndarray  # int32

    background: Vec3  # scalar Vec3 — ``defaultColor`` (CudaTracer.cu:653)

    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_mat.shape[0]

    @property
    def num_point_lights(self) -> int:
        return self.pl_power.x.shape[0]

    @property
    def num_area_lights(self) -> int:
        return self.al_tri0.shape[0]

    @property
    def num_textures(self) -> int:
        return self.textures.shape[0]

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Host-side builder (numpy). The analog of the reference's ``Scene`` class —
# mutable vectors of primitives, frozen to device arrays at the end.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material, mirroring the reference ctor defaults
    (``RenderStructs.h:98-106``)."""

    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diff_avg: float = 0.0
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    spec_exp: float = 0.0
    spec_avg: float = 0.0
    ior: float = 1.0
    absorption: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    refr_avg: float = 0.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    flags: int = 0
    texture: int = -1      # SceneBuilder.add_texture id; modulates diffuse
    normal_map: int = -1   # SceneBuilder.add_texture id; tangent-space


class SceneBuilder:
    """Accumulates primitives host-side, then freezes into a device Scene."""

    def __init__(self):
        self.spheres: List[Tuple[np.ndarray, float, int]] = []
        self.triangles: List[Tuple[np.ndarray, ...]] = []  # v0,v1,v2,n0,n1,n2,mat
        self.tri_uvs: List[np.ndarray] = []                # [3,2] per triangle
        self.materials: List[MaterialSpec] = []
        self.textures: List[np.ndarray] = []               # [h,w,3] float32
        self.point_lights: List[Tuple[np.ndarray, np.ndarray]] = []
        self.area_lights: List[Tuple[np.ndarray, float, int]] = []  # power, area, tri0
        self.background = np.zeros(3, np.float32)

    # -- primitives --------------------------------------------------------
    def add_material(self, m: MaterialSpec) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, image) -> int:
        """Register an [h, w, 3] image (uint8 or float in [0,1]) and return
        its id for ``MaterialSpec.texture`` / ``normal_map``."""
        a = np.asarray(image)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        a = np.asarray(a, np.float32)
        if a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"texture must be [h, w, 3], got {a.shape}")
        self.textures.append(a)
        return len(self.textures) - 1

    def add_sphere(self, center, radius, material_idx: int):
        self.spheres.append((np.asarray(center, np.float32), float(radius), material_idx))

    def add_triangle(self, v0, v1, v2, n0, n1, n2, material_idx: int,
                     uv=None):
        """``uv``: optional ((u0,v0),(u1,v1),(u2,v2)) per-corner texture
        coordinates; zeros when omitted."""
        self.triangles.append(tuple(np.asarray(v, np.float32) for v in (v0, v1, v2, n0, n1, n2)) + (material_idx,))
        self.tri_uvs.append(np.zeros((3, 2), np.float32) if uv is None
                            else np.asarray(uv, np.float32).reshape(3, 2))

    def add_point_light(self, position, power):
        self.point_lights.append((np.asarray(position, np.float32), np.asarray(power, np.float32)))

    # -- composite models --------------------------------------------------
    def add_rect(self, transformation: np.ndarray, material_idx: int):
        """A unit rect (two triangles) under a 4x4 transform, normals via
        inverse-transpose — behavior of ``Scene.cpp:63-96``."""
        t = np.asarray(transformation, np.float32)
        verts = []
        for i in range(2):
            for j in range(2):
                v = t @ np.array([i - 0.5, j - 0.5, 0.0, 1.0], np.float32)
                verts.append(v[:3])
        n4 = np.linalg.inv(t.T) @ np.array([0.0, 0.0, 1.0, 0.0], np.float32)
        n = n4[:3] / np.linalg.norm(n4[:3])
        # Triangle split matches Scene.cpp:94-95: (v0,v1,v2) and (v3,v1,v2).
        self.add_triangle(verts[0], verts[1], verts[2], n, n, n, material_idx)
        self.add_triangle(verts[3], verts[1], verts[2], n, n, n, material_idx)

    def add_area_light(self, transformation: np.ndarray, material_idx: int, power):
        """Rect light; area from the first triangle's cross product doubled —
        behavior of ``Scene.cpp:40-55`` (the reference stores
        ``length(cross(e1, e2))`` which is exactly the rect's area)."""
        tri0 = len(self.triangles)
        self.add_rect(transformation, material_idx)
        v0, v1, v2 = self.triangles[tri0][:3]
        e1 = v1 - v2
        e2 = v2 - v0
        area = float(np.linalg.norm(np.cross(e1, e2)))
        self.area_lights.append((np.asarray(power, np.float32), area, tri0))

    # -- freeze ------------------------------------------------------------
    def build(self) -> Scene:
        def vec3_of(rows):
            a = np.asarray(rows, np.float32).reshape(-1, 3)
            return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        sph_c = vec3_of([s[0] for s in self.spheres]) if self.spheres else Vec3.zeros((0,))
        sph_r = jnp.asarray(np.asarray([s[1] for s in self.spheres], np.float32))
        sph_m = jnp.asarray(np.asarray([s[2] for s in self.spheres], np.int32))

        def tri_field(i):
            if not self.triangles:
                return Vec3.zeros((0,))
            return vec3_of([t[i] for t in self.triangles])

        tri_m = jnp.asarray(np.asarray([t[6] for t in self.triangles], np.int32))

        mats = self.materials or [MaterialSpec()]
        materials = Materials(
            diffuse=vec3_of([m.diffuse for m in mats]),
            specular=vec3_of([m.specular for m in mats]),
            absorption=vec3_of([m.absorption for m in mats]),
            emission=vec3_of([m.emission for m in mats]),
            spec_exp=jnp.asarray(np.asarray([m.spec_exp for m in mats], np.float32)),
            ior=jnp.asarray(np.asarray([m.ior for m in mats], np.float32)),
            diff_avg=jnp.asarray(np.asarray([m.diff_avg for m in mats], np.float32)),
            spec_avg=jnp.asarray(np.asarray([m.spec_avg for m in mats], np.float32)),
            refr_avg=jnp.asarray(np.asarray([m.refr_avg for m in mats], np.float32)),
            roughness=jnp.asarray(np.asarray([m.roughness for m in mats], np.float32)),
            flags=jnp.asarray(np.asarray([m.flags for m in mats], np.int32)),
            tex_id=jnp.asarray(np.asarray([m.texture for m in mats], np.int32)),
            nmap_id=jnp.asarray(np.asarray([m.normal_map for m in mats], np.int32)),
        )

        uvs = (np.asarray(self.tri_uvs, np.float32).reshape(-1, 3, 2)
               if self.triangles else np.zeros((0, 3, 2), np.float32))
        if self.textures:
            th = max(t.shape[0] for t in self.textures)
            tw = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), th, tw, 3), np.float32)
            hw = np.zeros((len(self.textures), 2), np.int32)
            for k, t in enumerate(self.textures):
                atlas[k, :t.shape[0], :t.shape[1]] = t
                hw[k] = (t.shape[0], t.shape[1])
        else:
            atlas = np.zeros((0, 1, 1, 3), np.float32)
            hw = np.zeros((0, 2), np.int32)

        pl_pos = vec3_of([p[0] for p in self.point_lights]) if self.point_lights else Vec3.zeros((0,))
        pl_pow = vec3_of([p[1] for p in self.point_lights]) if self.point_lights else Vec3.zeros((0,))
        al_pow = vec3_of([a[0] for a in self.area_lights]) if self.area_lights else Vec3.zeros((0,))
        al_area = jnp.asarray(np.asarray([a[1] for a in self.area_lights], np.float32))
        al_tri0 = jnp.asarray(np.asarray([a[2] for a in self.area_lights], np.int32))

        return Scene(
            sph_center=sph_c,
            sph_radius=sph_r,
            sph_mat=sph_m,
            tri_v0=tri_field(0),
            tri_v1=tri_field(1),
            tri_v2=tri_field(2),
            tri_n0=tri_field(3),
            tri_n1=tri_field(4),
            tri_n2=tri_field(5),
            tri_mat=tri_m,
            tri_uv0=jnp.asarray(uvs[:, 0]),
            tri_uv1=jnp.asarray(uvs[:, 1]),
            tri_uv2=jnp.asarray(uvs[:, 2]),
            materials=materials,
            textures=jnp.asarray(atlas),
            tex_hw=jnp.asarray(hw),
            pl_pos=pl_pos,
            pl_power=pl_pow,
            al_power=al_pow,
            al_area=al_area,
            al_tri0=al_tri0,
            background=Vec3(
                jnp.float32(self.background[0]),
                jnp.float32(self.background[1]),
                jnp.float32(self.background[2]),
            ),
        )


# -- small host-side transform helpers (degree-based, matching old glm) ------

def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def scale(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(v, np.float32)
    return m


def rotate_deg(angle_deg: float, axis) -> np.ndarray:
    """Axis-angle rotation in degrees (old glm's ``rotate`` took degrees,
    as used at ``Scene.cpp:254`` etc.)."""
    a = np.deg2rad(np.float32(angle_deg))
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    C = 1 - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        np.float32,
    )
    return m
