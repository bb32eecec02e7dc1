"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see the real single
CPU device; multi-device tests spawn subprocesses with their own flags."""
import os
import sys

import jax
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection suite (guarded ladder, quarantine, "
        "deadlines) — run via `make chaos` or `-m chaos`")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips "
        "without one — run on the card with `-m cuda`")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def subprocess_env(n_devices: int = 8):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env
