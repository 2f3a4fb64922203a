"""Test configuration.

The reference has no unit-test framework (SURVEY.md §4); this suite is the
new build's tier-1 gate.  By default everything runs on the CPU: Pallas
kernels interpreted (asked for explicitly through TPUSPMM_INTERPRET=1) and
distributed tests on 8 virtual CPU devices, configured through jax.config
before any backend is initialized.

``TPUSPMM_TEST_GPU=1`` leaves the platform alone and the kernels
compiled: that is how the ``gpu``-marked tests run on a card
(``pytest -m gpu``, phase 6 of chip_smoke.py).  Those tests decide inside
the ``gpu`` fixture whether a card is present, so the CPU run skips them.
"""

import os
import sys
import tempfile

# keep autotune's on-disk ranking cache out of the checkout's cache (and
# out of other test runs) — rankings measured interpreted are meaningless
os.environ["TPUSPMM_TUNE_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="tpuspmm-test-"), "tune.json")

import jax

if os.environ.get("TPUSPMM_TEST_GPU") != "1":
    os.environ.setdefault("TPUSPMM_INTERPRET", "1")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpuspmm.data import data_dir  # noqa: E402  (after sys.path insert)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with TPUSPMM_TEST_GPU=1 on a card)")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small32_dir():
    d = data_dir("small_32x32")
    if d is None:
        pytest.skip("corpus data not available")
    return d


@pytest.fixture(scope="session")
def small10_dir():
    d = data_dir("small_10x10")
    if d is None:
        pytest.skip("corpus data not available")
    return d
