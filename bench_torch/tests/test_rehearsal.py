"""A small run of every cell on the CPU's plain path, for control flow; the
entry point without a card; the result line's keys; the imports; and that a
configuration, a traffic mix and a metric are added as files alone."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from bench_torch import harness

WORKLOADS = ["smoother_ex4.fused", "linreg_ex3.fused"]
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
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == WORKLOADS


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


def copy_with(root, tmp_path, entries):
    """The benchmark and a link to the program in ``tmp_path``, with ``entries``
    ({key: [entry, ...]}) added to its BENCHMARK.json."""
    shutil.copytree(root / "bench_torch", tmp_path / "bench_torch", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "openmcmc_tpu_torch").symlink_to(root / "openmcmc_tpu_torch")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, more in entries.items():
        bench[key] += more
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path / "bench_torch"


def run_copy(tmp_path, workload, overrides, trace_on=False):
    """A small CPU run of a workload of the copy, in a process of its own."""
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(tmp_path)!r})
        from pathlib import Path
        from bench_torch import harness
        cell = harness.load_cell(Path({str(tmp_path)!r}), {workload!r}, {trace_on})
        out = harness.run_cell(Path({str(tmp_path)!r}), {workload!r}, 5, 0.5, {trace_on}, "cpu", {overrides!r})
        print(json.dumps({{"metrics": [m["name"] for m, _ in cell.metrics], "out": out}}))
    """)
    got = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    return json.loads(got.stdout.strip().splitlines()[-1])


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
    here = copy_with(root, tmp_path, {
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
