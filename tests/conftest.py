"""Test configuration: force a CPU backend with 8 virtual devices.

Correctness tests run on the host CPU in float64, with an 8-device virtual
mesh for the sharding tests — the standard way to test mesh layouts without
several cards (see SURVEY.md §4).  The main path is plain JAX, so nothing
here needs a GPU; ``chip_smoke.py`` runs it on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Heavyweight modules (8-device sharded loops, large solves): every test
# in them is marked ``slow`` unless it carries an explicit ``fast`` marker
# (the per-subsystem smoke tests kept in the commit-gating core).  The
# core is ``pytest -m "not slow"``, budgeted at < 90 s on one CPU core;
# the full suite stays the CI run.
SLOW_MODULES = {
    "test_sharding", "test_post_interp", "test_continuous_ssy",
    "test_continuous_gcy", "test_reference_anchors", "test_cli",
    "test_sdf_pipeline", "test_krylov", "test_calibration",
    "test_degroot",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in SLOW_MODULES and "fast" not in item.keywords:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
