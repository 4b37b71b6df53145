"""cuda_path_tracer_ss — a differentiable path tracer in JAX, with a fused
Pallas-Triton kernel for NVIDIA GPUs.

A from-scratch JAX/Pallas re-design of the capabilities of
steveschwarcz/Cuda-Path-Tracer-SS (see SURVEY.md): iterative path tracing
with next-event estimation, masked-wavefront "stream compaction",
importance-sampled Lambert/Phong/Cook-Torrance BSDFs, jittered AA, area and
point lights, reflection/refraction with absorbance — plus capabilities the
reference lacks: end-to-end differentiability, SPMD multi-card rendering
over a device mesh, exact checkpoint/resume, and a test suite.
"""

from .constants import (
    DEFAULT_DIM,
    DEFAULT_MAX_BOUNCES,
    GAMMA_CORRECTION,
    LIVE_RAY_CUTOFF,
    RAY_BUMP_EPSILON,
)
from .models.camera import Camera
from .models.presets import PRESETS, get_scene
from .models.scene import (
    MaterialSpec,
    Materials,
    MAT_FLAG_COOK_TORRANCE,
    MAT_FLAG_PURE_REFLECTION,
    Scene,
    SceneBuilder,
)
from .ops.vec import Vec3
from .render.integrator import camera_arrays, render, render_sample, trace
from .render.inverse import directional_fd_check, extract_params, invert, merge_params
from .render.renderer import ProgressiveRenderer, RenderConfig

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "DEFAULT_DIM",
    "DEFAULT_MAX_BOUNCES",
    "GAMMA_CORRECTION",
    "LIVE_RAY_CUTOFF",
    "MaterialSpec",
    "Materials",
    "MAT_FLAG_COOK_TORRANCE",
    "MAT_FLAG_PURE_REFLECTION",
    "PRESETS",
    "ProgressiveRenderer",
    "RAY_BUMP_EPSILON",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "Vec3",
    "camera_arrays",
    "directional_fd_check",
    "extract_params",
    "get_scene",
    "invert",
    "merge_params",
    "render",
    "render_sample",
    "trace",
]
