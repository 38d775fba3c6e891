"""Test configuration: CPU backend with a virtual 8-device mesh, x64 on.

Mirrors the reference's tolerance-based unit-test strategy (SURVEY.md §4) on
a CPU fake of a device mesh (``xla_force_host_platform_device_count=8``), so
sharding paths are exercised without hardware.  The platform is switched via
``jax.config`` so that the suite stays on the CPU even where JAX would pick
a GPU by default.  Tests marked ``gpu`` need the card: the ``gpu`` fixture
skips them unless pytest runs with ``--gpu``, which leaves JAX on its default
backend (``python -m pytest tests/ -m gpu --gpu -p no:xdist`` on the card).
"""
import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (multi-minute XLA compiles)",
    )
    parser.addoption(
        "--gpu", action="store_true", default=False,
        help="leave JAX on its default backend so that tests marked gpu run",
    )


def pytest_configure(config):
    if not config.getoption("--gpu"):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    config.addinivalue_line(
        "markers", "slow: multi-minute compile; excluded from the default run "
        "(enable with --runslow)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped on the CPU by the `gpu` "
        "fixture")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow (compile-heavy): use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skips unless JAX runs on a GPU (pytest --gpu on a machine with one)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
