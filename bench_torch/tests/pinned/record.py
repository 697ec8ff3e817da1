"""Records ``pinned/<workload>.json``: a cell's result line at one seed, the
small sizes (``tests/small/``) and a fixed number of fits, on the CPU with one
torch thread, from the benchmark of the tree given (its ``bench_torch`` and
``openmcmc_tpu_torch``), as ``test_result_line_is_pinned`` runs it.

    python3 bench_torch/tests/pinned/record.py <tree> --label <which tree> [--workloads ...] [--seed N] [--fits N]

The pins hold the lines of the tree before a configuration could bring its
own check and count; ``recorded`` says which tree, torch, thread count and
CPU gave them (a CPU of another vector width may round otherwise).
"""

import argparse
import json
import platform
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parents[1]


def record(tree: Path, label: str, workload: str, seed: int, fits: int) -> dict:
    import torch

    from bench_torch import harness
    from fixed_fits import ending_after

    config = harness.load_cell(tree, workload, False).config_name
    small = json.loads((TESTS / "small" / f"{config}.json").read_text())
    with ending_after(harness, workload, fits, tree):
        out, run = harness.measure(tree, workload, seed, 1e9, False, "cpu", overrides=small)
    line = {k: v for k, v in out.items() if k != "metrics"}
    line["metrics"] = sorted(out["metrics"])
    return {"seed": seed, "fits": fits, "line": line,
            "run": {k: getattr(run, k) for k in ("sweeps", "precision", "flop", "bytes", "ess")},
            "recorded": {"tree": label, "torch": torch.__version__, "threads": torch.get_num_threads(),
                         "cpu_capability": torch.backends.cpu.get_cpu_capability(), "machine": platform.machine(),
                         "python": platform.python_version(),
                         "command": f"record.py <tree> --seed {seed} --fits {fits} --workloads {workload}"}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree", type=Path)
    parser.add_argument("--label", required=True)
    parser.add_argument("--workloads", nargs="+", default=["smoother_ex4.fused", "linreg_ex3.fused"])
    parser.add_argument("--seed", type=int, default=2**31 + 4243)
    parser.add_argument("--fits", type=int, default=7)
    parser.add_argument("--out", type=Path, default=Path(__file__).resolve().parent)
    args = parser.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree), str(TESTS)]
    import torch

    torch.set_num_threads(1)
    for workload in args.workloads:
        pin = record(tree, args.label, workload, args.seed, args.fits)
        (args.out / f"{workload}.json").write_text(json.dumps(pin, indent=1) + "\n")
        print(workload, json.dumps(pin["line"]["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
