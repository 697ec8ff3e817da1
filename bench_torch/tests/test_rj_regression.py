"""The reversible-jump regression's own count and check (``counts/``,
``checks/rj_posterior.py``, ``reference/rj_regression.py``) at a small size on
the CPU: the count is ``chip_smoke.py``'s, weighted by the drawn counts; the
control and each planted fault read not correct, each by the number meant to
catch it, and the reference sampler's own float64 draws read correct.

The small sizes (``small/rj_regression.json``) narrow the knots' domain to
[-4, 4], widen the walks' steps and start tau_y at 10, so that 120 sweeps of
burn-in forget the start and chains left at it stand out; 512 chains, because
the count's and tau_y's z of half the chains left out grow with the square
root of the chains (about 31 at the cell's 2048, 4 to 7 at 64)."""

import json

import pytest
import torch
from conftest import ROOT, small_sizes
from fixed_fits import ending_after

from bench_torch import calibrate, check, harness
from bench_torch.faults import FAULTS, planted

CELL = "rj_regression.fused_long"
SEED = 2**31 + 6007


def test_fit_drawn_is_chip_smokes_count_at_the_drawn_counts():
    """``flop_per_sweep`` equals ``chip_smoke.py``'s ``rj_flop_per_sweep(k,
    n_max, n_data, lik=True)`` at every k from 1 to n_max, and ``fit_drawn``
    weights it by each stored sweep's count over the fit's sweeps."""
    smoke = harness.load_module(ROOT / "chip_smoke.py")
    counts = harness.load_module(ROOT / "bench_torch" / "counts" / "rj_regression.py")
    cfg = harness.load_cell(ROOT, CELL, False).config
    n_max, n_data = cfg["n_max"], cfg["n_data"]
    for k in range(1, n_max + 1):
        want = float(smoke.rj_flop_per_sweep(k, n_max, n_data, True))
        assert float(counts.flop_per_sweep(k, n_max, n_data)) == want
    k = torch.tensor([[1, 5, 20], [3, 3, 7]], dtype=torch.int32)
    flop, n_bytes = counts.fit_drawn(cfg, {"k": k})
    per = sum(float(smoke.rj_flop_per_sweep(int(v), n_max, n_data, True)) for v in k.reshape(-1))
    assert flop == pytest.approx(per * (cfg["n_burn"] + cfg["n_iter"]) / 3, rel=1e-12)
    assert n_bytes == 4 * (2 * n_data + 2 * (3 * n_max + 8) + 2 * 3 * (9 + 3 * n_max))


@pytest.fixture(scope="module")
def readings():
    """The control in TF32 and in float64, and one fit with each planted fault,
    judged by the cell's own check."""
    cell = harness.load_cell(ROOT, CELL, False)
    small = small_sizes("rj_regression")
    got = {"limits": check.limits(cell.config, cell.check.NUMBERS)}
    for precision in ("tf32", "float64"):
        got[precision] = calibrate.control(CELL, SEED, precision, torch.device("cpu"), small)
    for fault in sorted(FAULTS):
        with planted(fault, cell.model), ending_after(harness, CELL, 1, ROOT):
            out = harness.measure(ROOT, CELL, SEED, 1e9, False, "cpu", overrides=small)[0]
        got[fault] = {k: out[k] for k in ("correct", "failed", "checks")}
    return got


def passes(got, lims, names):
    return {k: check.passes(got[k], lims[k]) for k in names}


def test_the_control_fails_by_lp_gap_and_float64_draws_pass(readings):
    lims = readings["limits"]
    assert not passes(readings["tf32"], lims, ["lp_gap"])["lp_gap"], readings["tf32"]
    assert all(passes(readings["float64"], lims, lims).values()), readings["float64"]


@pytest.mark.parametrize("fault, caught_by", [("a_draw_altered", ["lp_gap"]),
                                              ("state_unchanged", ["count_z", "tau_z"]),
                                              ("half_the_chains_left_out", ["count_z", "tau_z"])])
def test_each_fault_is_caught_by_its_number(readings, fault, caught_by):
    assert fault in FAULTS
    out = readings[fault]
    values = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is False and out["failed"] == 1, json.dumps(out["checks"])
    assert not all(passes(values, readings["limits"], caught_by).values()), values
