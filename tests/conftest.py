"""Test harness: an 8-device virtual CPU platform, set up BEFORE jax
is imported.

Multi-host / multi-chip logic is validated on this fake mesh
(SURVEY §4).  When the tests run inside a process that has already
started JAX on a GPU (``chip_smoke.py`` runs the ``gpu`` tests that
way), the platform is left as it is.
"""

import os
import sys

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
