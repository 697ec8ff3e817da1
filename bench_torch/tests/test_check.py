"""The check fails what it must: the control (the plain reference put in the
program's place, computed with TF32 matrix products) and a run whose timed
path is broken underneath, once for each fault a fit can have (``faults.py``);
and it passes the reference's own exact draws."""

import json

import pytest
import torch

from bench_torch import calibrate, check, harness
from bench_torch.faults import FAULTS, planted

SEED = 2**31 + 4243


def limits(root, workload):
    return check.limits(harness.load_cell(root, workload, False).config)


@pytest.mark.parametrize("workload", ["smoother_ex4.fused", "linreg_ex3.fused"])
def test_the_control_fails_and_exact_draws_pass(root, small, workload):
    lims = limits(root, workload)
    got = calibrate.control(workload, SEED, "tf32", torch.device("cpu"), small(workload))
    assert not all(check.passes(got[k], lims[k]) for k in check.NUMBERS), got
    exact = calibrate.control(workload, SEED, "float64", torch.device("cpu"), small(workload))
    assert all(check.passes(exact[k], lims[k]) for k in check.NUMBERS), exact


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["smoother_ex4.fused", "linreg_ex3.fused"])
def test_a_broken_timed_path_is_not_correct(root, small, workload, fault):
    with planted(fault):
        out = harness.run_cell(root, workload, SEED, 0.5, False, "cpu", overrides=small(workload))
    assert out["correct"] is False and out["failed"] >= 1, json.dumps(out["checks"])
