# NOTE: deliberately NO XLA_FLAGS device-count override here — smoke tests
# and benches must see the single real CPU device. Multi-device tests spawn
# subprocesses (tests/test_distributed.py) or run under their own module
# guard (pytest-forked not available offline).
import os
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside a fixture without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def mf_corpus():
    """Small MF-structured corpus shared across search tests."""
    from repro.data.synthetic import mf_factors
    x = mf_factors(4000, 48, 12, decay=0.3, seed=0, norm_tail=0.3)
    q = mf_factors(32, 48, 12, decay=0.3, seed=1)
    return x, q
