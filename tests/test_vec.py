import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.ops.vec import Vec3, gather, where


def _v(*rows):
    a = np.asarray(rows, np.float32)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def test_arithmetic_and_dot():
    a = _v([1, 2, 3], [0, 1, 0])
    b = _v([4, 5, 6], [0, 2, 0])
    np.testing.assert_allclose((a + b).to_array(), [[5, 7, 9], [0, 3, 0]])
    np.testing.assert_allclose((a - b).to_array(), [[-3, -3, -3], [0, -1, 0]])
    np.testing.assert_allclose((a * 2.0).to_array(), [[2, 4, 6], [0, 2, 0]])
    np.testing.assert_allclose(np.asarray(a.dot(b)), [32, 2])


def test_cross_matches_numpy():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    got = (Vec3.from_array(x).cross(Vec3.from_array(y))).to_array()
    np.testing.assert_allclose(got, np.cross(x, y), rtol=1e-5, atol=1e-6)


def test_normalize():
    v = _v([3, 0, 4])
    n = v.normalize()
    np.testing.assert_allclose(n.to_array(), [[0.6, 0, 0.8]], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(n.norm()), [1.0], rtol=1e-6)


def test_where_and_gather():
    table = _v([1, 1, 1], [2, 2, 2], [3, 3, 3])
    idx = jnp.asarray([2, 0, 1, 2])
    g = gather(table, idx)
    np.testing.assert_allclose(np.asarray(g.x), [3, 1, 2, 3])
    sel = where(jnp.asarray([True, False, True, False]), g, Vec3.zeros((4,)))
    np.testing.assert_allclose(np.asarray(sel.x), [3, 0, 2, 0])
