"""The benchmark of openmcmc_tpu_torch on one NVIDIA card.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. Prints the result as
one JSON line, the last of standard output, and the checks' numbers beside
their limits as the last lines of standard error. Exits non-zero, printing no
result, where the card or the program is missing.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, to 10 ms (Linux's
    ``/proc``: the start in clock ticks after boot, against the uptime)."""
    now = time.perf_counter()
    ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def main(argv=None) -> int:
    import argparse

    start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every cache a kernel build or compiler might keep, at fixed paths inside the checkout
    cache = ROOT / ".bench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import harness

    cell = harness.load_cell(ROOT, args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", start=start)
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
