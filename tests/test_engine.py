"""Engine choice, compile-cache placement, and the GPU-only entry points'
refusal to run anywhere else."""
import os
import subprocess
import sys

import pytest

from cuda_path_tracer_ss.render.engine import resolve_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("engine,accel,backend,want", [
    ("auto", "none", "cpu", "jnp"),
    ("auto", "none", "gpu", "pallas"),
    ("auto", "grid", "gpu", "jnp"),       # the kernel has no grid traversal
    ("jnp", "grid", "gpu", "jnp"),
    ("pallas_interpret", "none", "cpu", "pallas_interpret"),
    ("auto", "none", "rocm", "jnp"),      # auto never picks interpret mode
])
def test_resolve_engine(engine, accel, backend, want):
    assert resolve_engine(engine, accel, backend=backend) == want


@pytest.mark.parametrize("engine,accel", [
    ("pallas", "grid"), ("pallas_interpret", "grid"), ("mosaic", "none")])
def test_resolve_engine_refuses(engine, accel):
    with pytest.raises(ValueError):
        resolve_engine(engine, accel, backend="gpu")


def test_renderer_refuses_fused_engine_with_grid():
    from cuda_path_tracer_ss.models import presets
    from cuda_path_tracer_ss.models.camera import Camera
    from cuda_path_tracer_ss.render.renderer import (
        ProgressiveRenderer, RenderConfig)
    cfg = RenderConfig(width=8, height=8, engine="pallas_interpret",
                       accel="grid")
    with pytest.raises(ValueError, match="grid"):
        ProgressiveRenderer(presets.cornell_empty(), Camera(), cfg)


@pytest.mark.parametrize("engine", ["pallas", "pallas_interpret", "auto"])
def test_training_refuses_forward_only_engines(engine):
    """The fused kernel renders forward only: asking it for gradients must
    fail loudly instead of training on a silent zero."""
    from cuda_path_tracer_ss.render import inverse
    with pytest.raises(ValueError, match="no gradient"):
        inverse.check_engine_fields(engine, ["materials.diffuse"])
    inverse.check_engine_fields("jnp", ["materials.diffuse", "sph_center"])


def test_compile_cache_honours_env_var(tmp_path, monkeypatch):
    import jax
    from cuda_path_tracer_ss.utils import compile_cache

    monkeypatch.delenv("CPT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "env")
    # left to JAX itself: nothing else is configured
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_inside_checkout():
    from cuda_path_tracer_ss.utils import compile_cache

    assert compile_cache.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stdout + r.stderr
