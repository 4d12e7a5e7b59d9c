"""Test configuration: 8 virtual CPU devices, float64 enabled.

The reference validates its distributed kernels only on a real cluster
(SURVEY.md §4); here every strategy is testable on one host via XLA's
virtual CPU devices — the multi-device mesh tests run on an 8-device CPU
mesh and the same code paths run unchanged on a GPU mesh.

Tests marked ``gpu`` need a card: they skip on the CPU. Run them on a
GPU machine with ``SPMM_TEST_GPU=1 python -m pytest tests -m gpu``
(the variable keeps this file from pinning the CPU platform).
"""

import os

if os.environ.get("SPMM_TEST_GPU") != "1":
    # Must be set before jax initializes its backends.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("SPMM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs[:8]


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The first GPU; skips the test when JAX runs on anything else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
