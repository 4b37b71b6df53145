"""Field addressing for the inverse renderer (extract/with/merge)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cuda_path_tracer_ss.models import presets
from cuda_path_tracer_ss.render import inverse


def test_get_and_with_field_roundtrip():
    scene = presets.cornell()
    d = inverse.get_field(scene, "materials.diffuse")
    assert d.shape[-1] == 3
    new = jnp.zeros_like(d) + 0.5
    scene2 = inverse.with_field(scene, "materials.diffuse", new)
    np.testing.assert_array_equal(
        np.asarray(inverse.get_field(scene2, "materials.diffuse")), 0.5)
    # original untouched (frozen dataclasses)
    np.testing.assert_array_equal(np.asarray(inverse.get_field(scene, "materials.diffuse")),
                                  np.asarray(d))


def test_scalar_field():
    scene = presets.cornell()
    r = inverse.get_field(scene, "materials.roughness")
    scene2 = inverse.with_field(scene, "materials.roughness", r + 0.1)
    np.testing.assert_allclose(
        np.asarray(inverse.get_field(scene2, "materials.roughness")),
        np.asarray(r) + 0.1)


def test_top_level_vec3_field():
    scene = presets.cornell()
    c = inverse.get_field(scene, "sph_center")
    scene2 = inverse.with_field(scene, "sph_center", c + 1.0)
    np.testing.assert_allclose(np.asarray(inverse.get_field(scene2, "sph_center")),
                               np.asarray(c) + 1.0)


def test_merge_multiple():
    scene = presets.cornell()
    params = inverse.extract_params(scene, ["al_power", "materials.emission"])
    params = {k: v * 2.0 for k, v in params.items()}
    scene2 = inverse.merge_params(scene, params)
    np.testing.assert_allclose(np.asarray(inverse.get_field(scene2, "al_power")),
                               2 * np.asarray(inverse.get_field(scene, "al_power")))


def test_unknown_field_raises():
    scene = presets.cornell()
    with pytest.raises(AttributeError):
        inverse.get_field(scene, "materials.nope")
