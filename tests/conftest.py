"""Test environment.

On the CPU (the default, and how the suite runs everywhere but on a card):
JAX's CPU backend with 8 virtual devices and float64 enabled.  This mirrors
the reference's strategy of building a float64 debug library for numeric
verification (cpp/CMakeLists.txt:20-37) and adds what the reference never
needed: a virtual 8-device mesh so multi-card sharding logic is testable
without a multi-card host (SURVEY.md §4).  The platform is set through
jax.config, which takes effect as long as no backend has been initialized.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on a card they
run with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`` (float32,
no virtual devices).  ``chip_smoke.py`` runs the same checks.
"""

import os

_ON_GPU = any(
    p in ("cuda", "gpu")
    for p in os.environ.get("JAX_PLATFORMS", "").split(",")
)

if not _ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
# Tests never write the persistent compile cache, whatever a CLI under test
# configures.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped without one (chip_smoke.py runs "
        "the same checks on the card)",
    )


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")


@pytest.fixture
def rng():
    return np.random.RandomState(1)
