"""The check fails what it must: the control (the plain reference put in the
program's place, computed with TF32 matrix products) and a run whose timed
path is broken underneath, once for each fault a fit can have (``faults.py``);
and it passes the reference's own exact draws. The same for a configuration
that brings its own check, control and fault site (the reversible-jump prior
recovery of ``rj_prior/``, added to a copy as files alone)."""

import json

import pytest
import torch
from conftest import RJ_CELL, WORKLOADS, run_in

from bench_torch import calibrate, check, harness
from bench_torch.faults import FAULTS, planted

SEED = 2**31 + 4243


def limits(root, workload):
    """The numbers of the cell's check and their limits."""
    cell = harness.load_cell(root, workload, False)
    return cell.check.NUMBERS, check.limits(cell.config, cell.check.NUMBERS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_exact_draws_pass(root, small, workload):
    numbers, lims = limits(root, workload)
    got = calibrate.control(workload, SEED, "tf32", torch.device("cpu"), small(workload))
    assert not all(check.passes(got[k], lims[k]) for k in numbers), got
    exact = calibrate.control(workload, SEED, "float64", torch.device("cpu"), small(workload))
    assert all(check.passes(exact[k], lims[k]) for k in numbers), exact


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(root, small, workload, fault):
    cell = harness.load_cell(root, workload, False)
    with planted(fault, cell.model):
        out = harness.run_cell(root, workload, SEED, 0.5, False, "cpu", overrides=small(workload))
    assert out["correct"] is False and out["failed"] >= 1, json.dumps(out["checks"])


@pytest.fixture(scope="module")
def rj_readings(rj_root):
    """The reversible-jump configuration's control in TF32 and in float64, and a
    run with each planted fault, judged by its own check in its copy."""
    return run_in(rj_root, f"""
        import torch
        sys.path.insert(0, str(ROOT / "bench_torch" / "tests"))
        from bench_torch import calibrate, check, faults, harness
        from fixed_fits import ending_after

        cell = harness.load_cell(ROOT, {RJ_CELL!r}, False)
        small = json.loads((ROOT / "bench_torch" / "tests" / "small" / "rj_prior.json").read_text())
        got = {{"numbers": list(cell.check.NUMBERS), "limits": check.limits(cell.config, cell.check.NUMBERS)}}
        for precision in ("tf32", "float64"):
            got[precision] = calibrate.control({RJ_CELL!r}, {SEED}, precision, torch.device("cpu"), small)
        for fault in sorted(faults.FAULTS):
            with faults.planted(fault, cell.model), ending_after(harness, {RJ_CELL!r}, 1, ROOT):
                out = harness.measure(ROOT, {RJ_CELL!r}, {SEED}, 1e9, False, "cpu", overrides=small)[0]
            got[fault] = {{k: out[k] for k in ("correct", "failed", "checks")}}
        print(json.dumps(got))
    """)["out"]


def test_a_configurations_own_control_fails_and_exact_draws_pass(rj_readings):
    numbers, lims = rj_readings["numbers"], rj_readings["limits"]
    assert numbers == ["lp_gap", "count_z"]
    assert not all(check.passes(rj_readings["tf32"][k], lims[k]) for k in numbers), rj_readings["tf32"]
    assert all(check.passes(rj_readings["float64"][k], lims[k]) for k in numbers), rj_readings["float64"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_configurations_own_fault_site_is_not_correct(rj_readings, fault):
    out = rj_readings[fault]
    assert out["correct"] is False and out["failed"] >= 1, json.dumps(out["checks"])
