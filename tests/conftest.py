"""Test configuration: run on an 8-device virtual CPU mesh.

Tests select the CPU the way stock JAX does, with JAX_PLATFORMS=cpu
(set here unless the caller chose a platform), and split it into 8
virtual devices BEFORE jax initializes — the standard JAX way to
exercise multi-device sharding without hardware (SURVEY.md section 4).
Tests marked `gpu` need the card; run them there with
JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from lbm_jax.device import setup_compile_cache  # noqa: E402

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR if set, else
# the checkout's fixed .jax_cache): reruns skip the larger compiles.
setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture(scope="session")
def reference_root():
    path = "/root/reference"
    if not os.path.isdir(path):
        pytest.skip("reference tree not available")
    return path


@pytest.fixture
def gpu_device():
    """The first JAX device, or a skip when it is not a GPU (decided
    here at run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev
