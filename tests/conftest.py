"""Test configuration: force CPU with an 8-device virtual mesh so sharding
tests exercise real multi-device paths without accelerator hardware (the
bench and chip_smoke.py run on the GPU).

``JAX_PLATFORMS`` defaults to ``cpu`` here and is applied through jax.config
after import as well. Tests marked ``gpu`` decide inside their body whether a
GPU exists; on a GPU host run them with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
