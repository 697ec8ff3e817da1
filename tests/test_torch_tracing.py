"""The port's tracer (``openmcmc_tpu_torch/utils/profiling.py``): off, it is one
shared null context that reads no clock; under ``record()``, ``MCMC.run``'s
spans form one tree per fit with the counters' changes kept per run.

CPU only: the fused engines run their plain versions, whose spans take the
kernels' names."""

import time

import numpy as np
import pytest
import torch

from openmcmc_tpu_torch.fused.layout import to_host, upload
from openmcmc_tpu_torch.utils import profiling
from torch_models import linreg_mcmc, smoother_mcmc

torch.set_num_threads(2)


def self_ns(spans) -> dict:
    """Each span's duration less what its children cover (ns), by span_id."""
    own = {s.span_id: s.t1_ns - s.t0_ns for s in spans}
    for s in spans:
        if s.parent_id in own:
            own[s.parent_id] -= s.t1_ns - s.t0_ns
    return own


CASES = {"smoother": (smoother_mcmc, "fused_smoother_spectral", "kernel.spectral_smoother"),
         "linreg": (linreg_mcmc, "fused_linreg", "kernel.linreg")}


def test_off_is_one_null_context_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with recording off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    first, second = profiling.trace_annotated("a"), profiling.trace_annotated("b", hit=True)
    assert first is second
    with first as got:
        assert got is None
        profiling.annotate(engine="x")

    @profiling.traced("c")
    def f(v):
        return v + 1

    assert f(1) == 2


def test_one_recording_at_a_time():
    with profiling.record() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.record():
                pass
        with profiling.trace_annotated("outer", k=1):
            with profiling.trace_annotated("inner"):
                profiling.annotate(v=2)
    assert profiling.trace_annotated("after") is profiling.trace_annotated("after")
    inner, outer = rec.spans
    assert (inner.name, inner.parent_id, inner.attrs) == ("inner", outer.span_id, {"v": 2})
    assert (outer.name, outer.parent_id, outer.run_id, outer.attrs) == ("outer", None, None, {"k": 1})
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    # the offset puts perf_counter_ns on time_ns: now, to well under a second
    assert abs(time.perf_counter_ns() + rec.clock_offset_ns - time.time_ns()) < 10**9


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_fit_is_one_span_tree(case):
    make, engine, kernel = CASES[case]
    mcmc = make(3)
    with profiling.record() as rec:
        profiling.count("test.outside_a_run")
        first = mcmc.run(engine="auto")
        profiling.count("test.outside_a_run")
        mcmc.seed = 4
        second = mcmc.run(engine="auto")
    assert first.engine == second.engine == engine
    roots = sorted((s for s in rec.spans if s.name == profiling.RUN), key=lambda s: s.t0_ns)
    assert len(roots) == 2 and len(rec.spans) == 10
    own = self_ns(rec.spans)
    for hit, root in zip((False, True), roots):
        assert root.parent_id is None and root.run_id == root.span_id and root.attrs == {"engine": engine}
        kids = sorted((s for s in rec.spans if s.parent_id == root.span_id), key=lambda s: s.t0_ns)
        assert [s.name for s in kids] == ["mcmc.match", "fused.prepare", kernel, "mcmc.repackage"]
        assert kids[0].attrs == {"hit": hit}
        assert all(s.run_id == root.span_id for s in kids)
        bounds = [root.t0_ns] + [t for s in kids for t in (s.t0_ns, s.t1_ns)] + [root.t1_ns]
        assert bounds == sorted(bounds)  # nested, in order, not overlapping
        assert all(own[s.span_id] >= 0 for s in [root, *kids])
        counts = rec.runs[root.span_id]
        assert counts == {"mcmc.runs": 1}  # the CPU: no card, so no copy, read or launch
    assert profiling.counters()["test.outside_a_run"] >= 2


def test_a_generic_run_is_a_root_with_its_engine():
    mcmc = smoother_mcmc(5)
    with profiling.record() as rec:
        mcmc.run(engine="generic")
    roots = [s for s in rec.spans if s.name == profiling.RUN]
    assert len(roots) == 1 and roots[0].attrs == {"engine": "generic"}
    assert "mcmc.match" not in {s.name for s in rec.spans}


def test_upload_counts_copies_bound_for_a_device():
    before = profiling.counters()
    host = upload(np.arange(5.0), "cpu")
    assert host.dtype == torch.float32 and torch.equal(host, torch.arange(5.0))
    assert torch.equal(to_host(host), host)
    assert profiling.counters() == before  # nothing leaves or reaches a card
    meta = upload(np.arange(5.0), "meta")  # a device without memory: the copy is counted, not made
    assert meta.device.type == "meta" and meta.dtype == torch.float32
    after = profiling.counters()
    assert after.get("h2d.copies", 0) - before.get("h2d.copies", 0) == 1
    assert after.get("h2d.bytes", 0) - before.get("h2d.bytes", 0) == 20
    assert upload(meta, "meta") is meta and profiling.counters() == after
