"""Test configuration: the CPU with 8 virtual devices, so sharding tests
run without several cards (SURVEY §4 test strategy, item 5).

Tests marked ``gpu`` need the card: they skip here, from the fixture below,
and run on the GPU with ``CPT_GPU_TESTS=1`` (``chip_smoke.py`` runs them in
its own process). Whether a card exists is decided inside that fixture,
never while a module is imported, so every pytest-xdist worker collects the
same tests.
"""
import os

import pytest

_USE_GPU = os.environ.get("CPT_GPU_TESTS") == "1"
if not _USE_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # CPU sessions keep the persistent compile cache off: tests/test_cli.py
    # invokes cli.main() IN-PROCESS, which calls enable_persistent_cache(),
    # and every later test's executables would then be written to the
    # cache directory mid-session.
    os.environ.setdefault("CPT_NO_COMPILE_CACHE", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _USE_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    """Skip ``gpu``-marked tests when JAX has no GPU backend."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: run with CPT_GPU_TESTS=1 on the card "
                    "(python chip_smoke.py runs these)")
