"""SoA 3-vector math.

The reference uses glm's AoS ``vec3`` (``CudaTracer/RenderStructs.h:15``).
This framework keeps every vector quantity as a *structure of arrays*: three
arrays of shape ``[N]`` (or scalars), so every elementwise op runs over
contiguous per-ray vectors and the same component layout is what the fused
kernel keeps per ray in registers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

Array = Any


@jax.custom_jvp
def sqrt_clamped_grad(x):
    """sqrt whose TANGENT clamps 1/(2 sqrt x) near x = 0; forward value is
    bit-identical to jnp.sqrt. Guards the two grazing-geometry gradient
    blowups in the estimator: a tangent sphere hit (discriminant -> 0+,
    ops/intersect.sphere_t) and near-TIR refraction (1 - sin_t2 -> 0+,
    ops/optics) — one such ray injects inf/NaN into an otherwise-finite
    interior gradient (observed NaNing an Adam inverse run). Bias corridor
    is |sqrt(x)| < 1e-3 of the exact degeneracy."""
    return jnp.sqrt(x)


@sqrt_clamped_grad.defjvp
def _sqrt_clamped_grad_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(x)
    return y, dx * (0.5 / jnp.maximum(y, 1e-3))


@jax.custom_jvp
def rsqrt_clamped_grad(x):
    """``lax.rsqrt`` whose TANGENT clamps the x^(-3/2) factor (norms below
    1e-3 stop steepening); the forward value is bit-identical to
    ``lax.rsqrt``. Companion to :func:`sqrt_clamped_grad` for the
    normalize-of-a-near-zero-vector blowup: a degenerate tangent frame's
    normalize makes inf gradient factors, and even a ZERO cotangent
    through a discarded ``where`` branch times inf is NaN (the round-5
    find: textured-sphere geometry gradients NaN'd at the uv poles
    through the unused normal-map branch)."""
    return jax.lax.rsqrt(x)


@rsqrt_clamped_grad.defjvp
def _rsqrt_clamped_grad_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jax.lax.rsqrt(x)
    yc = jnp.minimum(y, 1e3)
    return y, dx * (-0.5 * yc * yc * yc)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Vec3:
    """Three same-shaped arrays acting as one vector field."""

    x: Array
    y: Array
    z: Array

    # -- constructors ------------------------------------------------------
    @staticmethod
    def full(shape, vals, dtype=jnp.float32) -> "Vec3":
        vx, vy, vz = vals
        return Vec3(
            jnp.full(shape, vx, dtype),
            jnp.full(shape, vy, dtype),
            jnp.full(shape, vz, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        return Vec3.full(shape, (0.0, 0.0, 0.0), dtype)

    @staticmethod
    def ones(shape, dtype=jnp.float32) -> "Vec3":
        return Vec3.full(shape, (1.0, 1.0, 1.0), dtype)

    @staticmethod
    def from_array(a) -> "Vec3":
        """Build from a trailing-dim-3 array ``[..., 3]``."""
        a = jnp.asarray(a)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self):
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        o = _lift(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        o = _lift(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = _lift(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = _lift(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        o = _lift(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry ----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return jnp.sqrt(self.norm2())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        n2 = self.norm2()
        if eps:
            n2 = jnp.maximum(n2, eps)
        inv = jax.lax.rsqrt(n2)
        return self * inv

    def normalize_clamped_grad(self, eps: float = 0.0) -> "Vec3":
        """``normalize`` with :func:`rsqrt_clamped_grad` — bit-identical
        values, finite gradients even for near-zero vectors (use where a
        degenerate input is possible and a ``where`` selects it away)."""
        n2 = self.norm2()
        if eps:
            n2 = jnp.maximum(n2, eps)
        inv = rsqrt_clamped_grad(n2)
        return self * inv

    # -- utility -----------------------------------------------------------
    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))

    def astype(self, dtype) -> "Vec3":
        return self.map(lambda a: a.astype(dtype))

    def sum(self, axis=None) -> "Vec3":
        return self.map(lambda a: jnp.sum(a, axis=axis))

    def mean_channels(self):
        return (self.x + self.y + self.z) / 3.0

    def max_channel(self):
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    @property
    def shape(self):
        return jnp.shape(self.x)

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def reshape(self, *shape) -> "Vec3":
        return self.map(lambda a: a.reshape(*shape))


def _lift(o) -> Vec3:
    if isinstance(o, Vec3):
        return o
    return Vec3(o, o, o)


def match_vma(ref, arr):
    """Mark ``arr`` as varying over the same manual mesh axes as ``ref``.

    Fresh constants (zeros_like/full_like) are 'unvarying' under shard_map's
    varying-manual-axes typing, which breaks scan/while carries whose outputs
    depend on per-device ray data. No-op outside shard_map.
    """
    ref_vma = getattr(jax.typeof(ref), "vma", frozenset())
    arr_vma = getattr(jax.typeof(arr), "vma", frozenset())
    missing = ref_vma - arr_vma
    if missing:
        arr = jax.lax.pcast(arr, tuple(missing), to="varying")
    return arr


def full_like_vma(ref, fill, dtype=None) -> Array:
    """``jnp.full_like`` that also inherits ``ref``'s varying manual axes."""
    return match_vma(ref, jnp.full_like(ref, fill, dtype=dtype))


def where(cond, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select with one broadcasted condition."""
    b = _lift(b)
    a = _lift(a)
    return Vec3(
        jnp.where(cond, a.x, b.x),
        jnp.where(cond, a.y, b.y),
        jnp.where(cond, a.z, b.z),
    )


def gather(table: Vec3, idx) -> Vec3:
    """Row-gather from a small table Vec3 of [M] components."""
    return Vec3(table.x[idx], table.y[idx], table.z[idx])
