"""Test config: force an 8-virtual-device CPU backend.

The suite runs on the CPU: unless ``JAX_PLATFORMS`` names another
platform, it is pinned to "cpu" through ``jax.config`` as well, so an
accelerator on the machine is never picked up by accident. Card-only
tests carry the ``gpu`` marker and skip off the card; run them there with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``. ``XLA_FLAGS`` must
be set before any backend is created.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Fast/heavy tiers (VERDICT r3 #4). The full suite costs ~35 min on this box
# (model training, on-mesh dryruns); the contract core — wire format, graph
# IR, node contracts, codec, executor — runs in well under a minute and is
# what the inner development loop needs green after every edit:
#   make test-fast      ≙  pytest -m fast   (~40 s)
#   make test           ≙  full suite        (round close)
# Modules are auto-marked here so individual tests never need decorators.
_FAST_MODULES = {
    "test_codec", "test_native_codec", "test_wire_fixtures",
    "test_wire_schema", "test_graph_ir", "test_node_contracts",
    "test_node_ops", "test_executor", "test_utils", "test_trace_agg",
    "test_partition_fixtures", "test_export_serving",
    "test_render_fixtures",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        item.add_marker("fast" if mod in _FAST_MODULES else "heavy")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never while a module is imported (pytest-xdist
    workers must all collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda "
                    "-m gpu on the card)")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)
