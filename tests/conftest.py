"""Shared fixtures.  NOTE: the 512-device XLA flag is set ONLY inside
launch/dryrun.py — tests and benches must see the real (1-device) platform."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped when none is present")
