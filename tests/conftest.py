"""Test configuration.

Tests run on CPU with 8 virtual devices so mesh/sharding behavior is
exercised without accelerator hardware (``dryrun_multichip`` does the same).
Tests that need a GPU carry the ``gpu`` marker and skip through the ``gpu`` fixture below when none is
present; run them on a GPU machine with ``python -m pytest -m gpu tests/``
(JAX_PLATFORMS unset). x64 is enabled so reference-accuracy checks
(integrator order, KKT residuals) are not limited by f32; production-path
f32 behavior is covered by dedicated tolerance tests that pass explicit
float32 inputs.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    when the test runs, never at import, so every xdist worker collects the
    same tests."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU")
    return devices[0]
