"""Test harness config.

By default the suite runs on an 8-device virtual CPU mesh, so sharding
paths are exercised without accelerator hardware.  Tests marked ``gpu``
need an NVIDIA GPU: run them with ``JAX_PLATFORMS=cuda python -m pytest
tests/ -m gpu`` on a machine that has one; elsewhere they skip.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX platform is %r)" % dev.platform)
    return dev
