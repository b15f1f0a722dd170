"""Test configuration.

By default every test runs on the CPU with 8 virtual devices, set before
any backend initializes, so the multi-device sharding tests run anywhere.
The config key is set as well as the env var so that a JAX installation
with a GPU plugin still initializes the CPU backend only.

Tests that need a CUDA device carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them unless JAX's default backend is a GPU. Run them
on a machine with a card, without the CPU override:

    PT_TEST_GPU=1 python -m pytest tests/ -m gpu
"""
import os

if os.environ.get("PT_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("PT_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless the default JAX backend is a GPU (decided at run time,
    never at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (run with PT_TEST_GPU=1 on a GPU)")
    return jax.devices()[0]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: multi-process / long-running tests")
    config.addinivalue_line("markers", "gpu: runs only on a CUDA device")
