"""The counts reproduce the bounds the port's kernel table states (PERF.md):
K1's whole run 1.652 ms (``smoother_ex4``), K6's whole run 0.0280 ms
(``linreg_ex3``)."""

import json

import pytest

from bench_torch.harness import load_module
from bench_torch.peaks import bound_s


def config(root, name):
    return json.loads((root / "bench_torch" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, want_ms, abs_ms", [("smoother_ex4", 1.652, 5e-4), ("linreg_ex3", 0.0280, 5e-5)])
def test_bound_matches_the_kernel_table(root, name, want_ms, abs_ms):
    counts = load_module(root / "bench_torch" / "counts" / f"{name}.py")
    flop, n_bytes = counts.fit(config(root, name))
    assert 1e3 * bound_s(flop, n_bytes) == pytest.approx(want_ms, abs=abs_ms)
    assert flop / 67e12 > n_bytes / 3.35e12  # each is bound by its operations
