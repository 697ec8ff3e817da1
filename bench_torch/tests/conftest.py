"""CPU tests of the benchmark: ``python -m pytest bench_torch/tests -q`` from the
repository's root. Every run here is the program's plain PyTorch path at a
small size, for control flow and the check's logic only; no number of it is a
device number.

The cells are BENCHMARK.json's; each configuration's small sizes are
``small/<config>.json``. ``rj_prior/`` holds a configuration that is not a
cell: the files a configuration with its own check, reference, count and
fault site brings (laid out as under ``bench_torch/``), which the tests add
to a copy of the benchmark as files alone."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIG_OF = {w["name"]: w["config"] for w in BENCH["workloads"]}

# the test-only configuration: reversible-jump prior recovery, a cell of a copy
RJ_CELL = "rj_prior.one_series"
RJ_ENTRIES = {
    "configs": [{"name": "rj_prior", "source": "https://github.com/sede-open/openMCMC",
                 "file": "bench_torch/configs/rj_prior.json", "reduced": [], "why": "a test"}],
    "workloads": [{"name": RJ_CELL, "config": "rj_prior", "traffic": "one_series", "chips": 1, "why": "a test"}],
    "end_to_end": [{"name": "ess_per_s.rj_prior", "unit": "ESS/s", "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": [RJ_CELL]}],
}


def small_sizes(config: str) -> dict:
    return json.loads((HERE / "small" / f"{config}.json").read_text())


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def small():
    """The small sizes of a workload's configuration."""
    return lambda workload: small_sizes(CONFIG_OF[workload])


def copy_with(dst: Path, entries: dict, overlay: Path = None) -> Path:
    """The benchmark and a link to the program in ``dst``, with ``entries``
    ({key: [entry, ...]}) added to its BENCHMARK.json and the files under
    ``overlay`` added to its ``bench_torch/``."""
    shutil.copytree(ROOT / "bench_torch", dst / "bench_torch", ignore=shutil.ignore_patterns("__pycache__"))
    if overlay is not None:
        shutil.copytree(overlay, dst / "bench_torch", dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "openmcmc_tpu_torch").symlink_to(ROOT / "openmcmc_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, more in entries.items():
        bench[key] += more
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst / "bench_torch"


def run_in(cwd: Path, body: str) -> dict:
    """``body`` in a process of its own, with the copy at ``cwd`` first on the
    path (its ``ROOT``); the JSON of its last line of standard output, and its
    standard error."""
    script = "\n".join(["import json, sys", "from pathlib import Path", f"ROOT = Path({str(cwd)!r})",
                        "sys.path.insert(0, str(ROOT))", textwrap.dedent(body)])
    got = subprocess.run([sys.executable, "-c", script], cwd=cwd, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr
    return {"out": json.loads(got.stdout.strip().splitlines()[-1]), "stderr": got.stderr}


@pytest.fixture(scope="session")
def rj_root(tmp_path_factory):
    """A copy of the benchmark with the reversible-jump prior-recovery
    configuration added as files and entries alone."""
    dst = tmp_path_factory.mktemp("rj")
    copy_with(dst, RJ_ENTRIES, HERE / "rj_prior")
    return dst
