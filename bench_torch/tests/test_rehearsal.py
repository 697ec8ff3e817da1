"""A small run of every cell on the CPU's plain path, for control flow; the
cells' result lines pinned at one seed; the entry point without a card; the
result line's keys; the imports; and that a configuration, a traffic mix and
a metric, and a configuration's own check, count, fault site and small sizes,
are added as files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import CONFIG_OF, HERE, RJ_CELL, WORKLOADS, copy_with, run_in, small_sizes
from fixed_fits import ending_after

from bench_torch import harness

SEED = 2**31 + 977  # above 32 signed bits: the entry takes any whole seed
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def check_line(out, traced):
    keys = list(out)
    assert keys[: len(REQUIRED)] == REQUIRED
    assert keys[-1] == "checks"  # the numbers compared come last
    assert set(keys) == set(REQUIRED) | {"checked", "checks"} | ({"breakdown", "traced_fits"} if traced else set())
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    json.dumps(out)


def test_every_workload_is_a_benchmark_cell(root):
    """Every cell of BENCHMARK.json runs here: its configuration has small sizes."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert WORKLOADS and [w["name"] for w in bench["workloads"]] == WORKLOADS
    for workload in WORKLOADS:
        assert set(small_sizes(CONFIG_OF[workload])) <= set(harness.load_cell(root, workload, False).config)


PINNED = sorted(p.stem for p in (HERE / "pinned").glob("*.json"))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", PINNED)
def test_result_line_is_pinned(root, small, workload, one_thread):
    """At one seed, the small sizes, a fixed number of fits and one torch
    thread, every field of the result line but the timed metrics' values, and
    the numbers the metrics read but the times, equal what the harness gave
    before a configuration could bring its own check and count
    (``pinned/<workload>.json``, made by ``pinned/record.py`` from that tree):
    the checks bit for bit."""
    pin = json.loads((HERE / "pinned" / f"{workload}.json").read_text())
    with ending_after(harness, workload, pin["fits"], root):
        out, run = harness.measure(root, workload, pin["seed"], 1e9, False, "cpu", overrides=small(workload))
    got = {k: out[k] for k in pin["line"] if k != "metrics"}
    assert {**got, "metrics": sorted(out["metrics"])} == pin["line"]
    assert {k: getattr(run, k) for k in pin["run"]} == pin["run"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_small_run_on_the_cpu(root, small, workload):
    out = harness.run_cell(root, workload, SEED, 1.0, False, "cpu", overrides=small(workload))
    check_line(out, traced=False)
    assert out["correct"] and out["failed"] == 0 and out["checked"] >= 1 and out["attempted"] >= 1
    assert out["device"]["platform"] == "cpu"  # a CPU run never names the card
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want and "setup_s" in want and len(want) >= 2


def test_traced_small_run_reports_no_device_number(root, small):
    workload = "linreg_ex3.fused"
    out = harness.run_cell(root, workload, SEED, 0.5, True, "cpu", overrides=small(workload))
    check_line(out, traced=True)
    # the CPU has no device trace: every per-layer metric finds nothing to read
    assert out["metrics"] == {} and out["device"]["busy_s"] == 0.0
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert out["traced_fits"] == {"fenced": 0, "unfenced": out["attempted"]}


def run_entry(cwd, *args):
    return subprocess.run([sys.executable, "bench_torch/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_the_entry_exits_nonzero_and_prints_nothing(root):
    got = run_entry(root, "--workload", "smoother_ex4.fused", "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA" in got.stderr


def test_without_the_program_the_entry_exits_nonzero_and_prints_nothing(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "bench_torch", tmp_path / "bench_torch", ignore=shutil.ignore_patterns("__pycache__"))
    got = run_entry(tmp_path, "--workload", "smoother_ex4.fused", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert got.returncode != 0 and got.stdout == ""


FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|openmcmc_tpu(?!_torch)|bench|bench_all|chip_smoke)\b", re.M)


def test_nothing_imports_jax_the_jax_package_or_the_old_scripts(root):
    files = sorted((root / "bench_torch").rglob("*.py"))
    assert files
    for path in files:
        assert not FORBIDDEN.search(path.read_text()), path


def run_copy(tmp_path, workload, overrides, trace_on=False):
    """A small CPU run of a workload of the copy, in a process of its own."""
    return run_in(tmp_path, f"""
        from bench_torch import harness
        cell = harness.load_cell(ROOT, {workload!r}, {trace_on})
        out = harness.run_cell(ROOT, {workload!r}, 5, 0.5, {trace_on}, "cpu", {overrides!r})
        print(json.dumps({{"metrics": [m["name"] for m, _ in cell.metrics], "out": out}}))
    """)["out"]


def test_every_metric_has_a_reader(root):
    """A metric's reader is ``metrics/<name>.py``, or for ``<quantity>.<config>``,
    the quantity split by the configurations whose cells report it, the
    quantity's own."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(harness.load_module(harness.reader_path(m["name"])), "read"), m["name"]


def test_a_split_metric_reads_its_quantity(root, small):
    workload = "smoother_ex4.fused"
    out, run = harness.measure(root, workload, SEED, 0.5, False, "cpu", overrides=small(workload))
    for name, got in out["metrics"].items():
        quantity = harness.load_module(root / "bench_torch" / "metrics" / f"{name.split('.')[0]}.py")
        assert got["value"] == quantity.read(run), name


def test_a_config_a_traffic_mix_and_a_metric_are_added_as_files(root, tmp_path):
    """A dummy configuration, traffic mix and end-to-end metric in a copy: files
    and BENCHMARK.json entries only; the harness finds and runs them."""
    here = copy_with(tmp_path, {
        "configs": [{"name": "dummy", "source": "https://example.org", "file": "bench_torch/configs/dummy.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": "dummy.dummy_mix", "config": "dummy", "traffic": "dummy_mix", "chips": 1,
                       "why": "a test"}],
        "end_to_end": [{"name": "dummy_count", "unit": "fits", "better": "higher", "bound": 0.25,
                        "source": "host_clock", "workloads": ["dummy.dummy_mix"]}]})
    cfg = json.loads((here / "configs" / "smoother_ex4.json").read_text())
    cfg.update(name="dummy", n_time=40, t_end=24.0, n_chains=32, n_burn=80, n_iter=40)
    (here / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (here / "counts" / "dummy.py").write_text("def fit(cfg):\n    return 1.0, 1.0\n")
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"engine": "auto", "data": "fresh", "check_fits": 2, "check_span": 3}))
    (here / "metrics" / "dummy_count.py").write_text("def read(run):\n    return float(len(run.walls))\n")
    res = run_copy(tmp_path, "dummy.dummy_mix", None)
    assert res["metrics"] == ["setup_s", "dummy_count"]
    assert res["out"]["correct"] and res["out"]["metrics"]["dummy_count"]["value"] >= 1


@pytest.fixture(scope="module")
def rj_run(rj_root):
    """A small CPU run of the reversible-jump configuration in its copy: its
    result line as ``report`` prints it, the :class:`Run`'s counts, and the
    stored counts of every fit of the window."""
    return run_in(rj_root, f"""
        sys.path.insert(0, str(ROOT / "bench_torch" / "tests"))
        from bench_torch import harness
        from fixed_fits import ending_after
        from openmcmc_tpu_torch.mcmc import MCMC

        counts, real = [], MCMC.run

        def run(self, *args, **kwargs):
            result = real(self, *args, **kwargs)
            counts.append(result.store["n_basis"][..., 0, 0].tolist())
            return result

        MCMC.run = run
        small = json.loads((ROOT / "bench_torch" / "tests" / "small" / "rj_prior.json").read_text())
        with ending_after(harness, {RJ_CELL!r}, 2, ROOT):
            out, r = harness.measure(ROOT, {RJ_CELL!r}, {SEED}, 1e9, False, "cpu", overrides=small)
        harness.report(out)
        print(json.dumps({{"out": out, "flop": r.flop, "bytes": r.bytes, "counts": counts[-out["attempted"]:],
                          "cfg": {{**harness.load_cell(ROOT, {RJ_CELL!r}, False).config, **small}}}}))
    """)


def test_a_config_brings_its_own_check_count_fault_site_and_small_sizes(rj_root, rj_run):
    """The reversible-jump configuration's check (``checks/count_marginal.py``),
    reference, count (``fit_drawn``), model with its fault site and small sizes
    are new files under ``tests/rj_prior/``, added to a copy with its entries
    alone; the harness runs it and prints that check's numbers last, in the
    result line and on standard error."""
    added = {str(p.relative_to(HERE / "rj_prior")) for p in (HERE / "rj_prior").rglob("*.*")
             if "__pycache__" not in p.parts}
    assert all(not (HERE.parent / name).exists() for name in added)  # none of them is a file the benchmark has
    out = rj_run["out"]["out"]
    check_line(out, traced=False)
    assert list(out["checks"]) == ["lp_gap", "count_z"]
    assert out["correct"] and out["checked"] == 2 and out["attempted"] == 2
    assert set(out["metrics"]) == {"setup_s", "ess_per_s.rj_prior"}
    tail = rj_run["stderr"].strip().splitlines()[-2:]
    assert [line.split()[1] for line in tail] == ["lp_gap", "count_z"]


def test_fit_drawn_is_the_windows_mean_of_each_fits_stored_counts(rj_root, rj_run):
    """``Run.flop`` of a configuration with ``fit_drawn`` is the mean over the
    window's fits of each fit's work at its stored counts, summed here by hand."""
    counts = harness.load_module(rj_root / "bench_torch" / "counts" / "rj_prior.py")
    cfg, got = rj_run["out"]["cfg"], rj_run["out"]
    per_fit = []
    for fit in got["counts"]:
        draws = [k for chain in fit for k in chain]
        stored = sum(float(counts.flop_per_sweep(k, cfg["n_max"], cfg["n_data"])) for k in draws)
        per_fit.append(stored * (cfg["n_burn"] + cfg["n_iter"]) / cfg["n_iter"])
    assert len(per_fit) == 2 and per_fit[0] != per_fit[1]
    assert got["flop"] == pytest.approx(sum(per_fit) / len(per_fit), rel=1e-12)
    chains, keep, p = cfg["n_chains"], cfg["n_iter"], cfg["n_max"]
    assert got["bytes"] == 4 * (cfg["n_data"] + chains * (3 * p + 7) + chains * keep * (8 + 3 * p))
