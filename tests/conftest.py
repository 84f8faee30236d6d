"""Test harness setup.

Tests run on the CPU with 8 virtual XLA devices, so that multi-device
sharding (`jax.sharding.Mesh` / `shard_map`) is exercised without a GPU.
Set JAX_PLATFORMS yourself (e.g. ``JAX_PLATFORMS=cuda,cpu``) to keep JAX's
own platform choice, which the tests marked ``gpu`` need:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

if "JAX_PLATFORMS" not in os.environ:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # float64 golden paths on CPU


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (multi-minute golden renders, "
             "sharded end-to-end equivalence)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow (run with --runslow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX computes on a GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on a card")
