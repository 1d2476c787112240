"""Test configuration: the CPU backend with 8 virtual devices by default.

Multi-device sharding paths (vision_basedsensor_tpu.parallel) are validated
on a virtual 8-device CPU mesh. This must run before any module imports jax.

A ``JAX_PLATFORMS`` already set in the environment is respected, so the
few tests marked ``gpu_only`` can run on a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu_only tests/

Whether a card is present is decided inside the ``gpu_device`` fixture, so
every worker collects the same tests; without one they skip.
"""
import os

_CPU_ONLY = os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu"

if _CPU_ONLY:
    # Some environments preload jax at interpreter startup (sitecustomize),
    # so env vars alone can be too late; set both env and live jax config.
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    # x64 aids the CPU parity oracles; the GPU runs (like production) stay
    # in float32.
    os.environ.setdefault("JAX_ENABLE_X64", "1")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _CPU_ONLY:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_platform_name", "cpu")
    jax.config.update("jax_enable_x64", True)
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) >= 8, "expected 8 virtual CPU devices"

# Persistent compilation cache (utils/cache.py): the suite's wall time is
# dominated by CPU jit compiles, so repeat runs start several times faster.
from vision_basedsensor_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the run has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu_only tests/")
    return gpus[0]
