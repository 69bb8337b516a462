# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device; only launch/dryrun.py forces 512 host devices.
import os

import numpy as np
import pytest

# every optimize() in the suite runs the IR verifier after each pass unless a
# run explicitly opts out (REPRO_VERIFY_IR=0)
os.environ.setdefault("REPRO_VERIFY_IR", "1")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA card; skips where torch sees none"
    )
