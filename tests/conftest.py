"""Test configuration: force an 8-device virtual CPU mesh for JAX tests.

The platform is also set via jax.config BEFORE any backend initializes, in
case jax was imported before these env vars were set.  Tests validate the
device code and shardings on the virtual CPU mesh; `python chip_smoke.py`
drives the GPU.
"""

import os
import sys

# XLA reads this when the CPU backend first initializes (must precede any
# jax.devices() call).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xB3714)
