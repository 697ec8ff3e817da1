"""CPU tests of the benchmark: ``python -m pytest bench_torch/tests -q`` from the
repository's root. Every run here is the program's plain PyTorch path at a
small size, for control flow and the check's logic only; no number of it is a
device number."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# small sizes of each configuration: enough chains and sweeps for the check's
# statistics, the published widths
SMALL = {
    "smoother_ex4": dict(n_chains=64, n_burn=100, n_iter=60),
    "linreg_ex3": dict(n_chains=64, n_burn=100, n_iter=60),
}


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def small():
    """The small sizes of a workload's configuration."""
    return lambda workload: SMALL[workload.split(".")[0]]
