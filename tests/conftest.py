"""Test environment: run everything on CPU with 8 virtual devices and x64
enabled, so numerical parity tests against the reference's float64 logs are
exact and multi-device sharding tests run without GPUs (SURVEY §4).

Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them when no GPU is present.  The CPU is pinned
unless JAX_PLATFORMS names other platforms: on a machine with a card run
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib

import numpy as np
import pytest

REFERENCE_DATA = pathlib.Path("/root/reference/outputs")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run the slow tier too (full CI-style pass; the default tier "
             "skips tests marked slow)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight multi-process / long-chain tests, skipped unless "
        "--runslow (the default tier keeps at least one fast correctness pin "
        "per subsystem)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped where JAX finds none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs, never at import,
    so every xdist worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: this test runs on the card")


@pytest.fixture(scope="session")
def reference_tree():
    """Root of the reference project's checkout, or skip when absent."""
    root = REFERENCE_DATA.parent
    if not root.exists():
        pytest.skip("reference tree not available")
    return root


@pytest.fixture(scope="session")
def golden_gazebo_log():
    """A reference-recorded closed-loop run (current log format): used as the
    parity oracle for nominal dynamics (x_pred_odom == RK4(x_odom, w_odom))."""
    import pickle

    p = REFERENCE_DATA / "gazebo_simulation/data/traj2_v10_a10_gp0.pkl"
    if not p.exists():
        pytest.skip("reference golden data not available")
    with open(p, "rb") as f:
        d = pickle.load(f)
    return {k: np.asarray(v) for k, v in d.items() if k in ("x_odom", "x_pred_odom", "w_odom", "t_odom")}
