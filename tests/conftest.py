"""Test configuration.

Unless the caller chose a platform, the tests run on the CPU with
``--xla_force_host_platform_device_count=8``, so the multi-device sharding
paths (parallel/) run on a virtual 8-device mesh exactly as SURVEY.md
section 4 prescribes.

Markers: ``gpu`` tests need a CUDA GPU and skip without one (the ``gpu``
fixture decides, at run time); ``slow`` tests are left out of the tier-1
run. ``python chip_smoke.py`` runs the ``gpu`` tests on the card.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA GPU (skips without one)")
    config.addinivalue_line("markers", "slow: left out of the tier-1 run")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a CUDA GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; run python chip_smoke.py on the card")
