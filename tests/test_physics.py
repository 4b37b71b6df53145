"""Property/statistical estimator tests — SURVEY §4 item 2 (energy
conservation, white furnace)."""
import jax
import jax.numpy as jnp
import numpy as np

from cuda_path_tracer_ss.models.camera import Camera
from cuda_path_tracer_ss.models.scene import MaterialSpec, SceneBuilder
from cuda_path_tracer_ss.render.integrator import camera_arrays, render


def _furnace_scene(albedo=1.0, diff_avg=1.0):
    b = SceneBuilder()
    b.background = np.array([1.0, 1.0, 1.0], np.float32)
    m = b.add_material(MaterialSpec(diffuse=(albedo,) * 3, diff_avg=diff_avg))
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m)
    return b.build()


def test_white_furnace_unit_albedo():
    # Unit-albedo diffuse sphere in a unit-radiance environment: every path
    # scatters off the convex sphere at most once, then escapes with
    # throughput 1 -> radiance exactly 1 everywhere.
    scene = _furnace_scene(1.0, 1.0)
    img = render(scene, camera_arrays(Camera()), 32, 32, 8,
                 0, max_bounces=6, live_cutoff=None)
    np.testing.assert_allclose(np.asarray(img), 1.0, rtol=2e-5)


def test_furnace_darkens_with_albedo():
    cp = camera_arrays(Camera())
    means = []
    for albedo in (1.0, 0.6, 0.2):
        scene = _furnace_scene(albedo, 1.0)
        img = render(scene, cp, 32, 32, 16, 1,
                     max_bounces=6, live_cutoff=None)
        means.append(float(jnp.mean(img)))
    assert means[0] > means[1] > means[2]
    # background pixels stay at 1 regardless; sphere pixels scale with albedo
    assert means[0] <= 1.0 + 1e-5


def test_absorbed_paths_carry_no_energy():
    # diff_avg < 1 terminates paths Russian-roulette style without pdf
    # division (CudaTracer.cu:316-317): terminated paths contribute nothing.
    scene_bright = _furnace_scene(1.0, 1.0)
    scene_rr = _furnace_scene(1.0, 0.5)
    cp = camera_arrays(Camera())
    a = np.asarray(render(scene_bright, cp, 32, 32, 16, 2,
                          max_bounces=6, live_cutoff=None))
    b = np.asarray(render(scene_rr, cp, 32, 32, 16, 2,
                          max_bounces=6, live_cutoff=None))
    assert b.mean() < a.mean()
    assert b.min() >= 0.0
