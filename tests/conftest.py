"""Test configuration: run JAX on the CPU with 8 virtual devices, so the
parity suite and the multi-device sharding logic run without a GPU.

Tests that need the card carry the `gpu` marker and skip here (the `gpu`
fixture decides at run time, inside the test). To run them on a GPU
machine, keep JAX on its default platform:

    RIP_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu
"""

import os

import pytest

if os.environ.get("RIP_TEST_PLATFORM") != "gpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU as JAX's default device (skips otherwise)"
    )


@pytest.fixture
def gpu():
    """JAX's first device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
