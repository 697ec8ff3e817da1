"""Time kernel K3 (csrc/tridiag_canonical.cu) of one or more trees of the
PyTorch/CUDA port on one NVIDIA GPU.

    python3 scripts/time_k3_torch.py TREE [TREE ...]

Each TREE is a checkout of this repository or an unpacked ``git archive`` of
one; list them in the order to run, for example parent, change, change, parent.
Each runs in a process of its own, which builds that tree's kernels and then,
at the generic flagship's shape (8192 chains, p = 100) and at the shape of
``thomas_long``'s generic twin (4096 chains, p = 4096), times
``linalg.tridiag.sample_canonical_tridiag`` on the card: the wrapper by CUDA
events (median over the calls) and the kernel by ``torch.profiler``'s device
time of the ``tridiag_canonical`` kernel (mean per launch). The inputs are
``chip_smoke.py``'s (``tridiag_inputs``, seeded by p). Prints the card's name
and power limit, then one JSON line per tree. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((8192, 100, 50), (4096, 4096, 10))  # chains, p, timed calls


def worker(tree: str) -> None:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from openmcmc_tpu_torch import _build
    from openmcmc_tpu_torch.linalg import tridiag

    if root not in Path(tridiag.__file__).resolve().parents:
        raise RuntimeError(f"imported {tridiag.__file__}, not the tree {root}")
    _build.library()
    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    for n_chains, p, reps in SHAPES:
        rng = np.random.default_rng(p)
        c = rng.uniform(-1.0, 1.0, (n_chains, p))
        c[:, -1] = 0.0
        a = 2.5 + rng.uniform(0.0, 3.0, (n_chains, p))
        b = rng.normal(size=(n_chains, p))
        a, c, b = (torch.as_tensor(t, dtype=torch.float32, device=dev) for t in (a, c, b))

        def call():
            return tridiag.sample_canonical_tridiag(7, 5, a, c, b)

        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(stop))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        kernel_us = [getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                     for e in prof.key_averages() if "tridiag_canonical" in e.key]
        out[f"{n_chains}x{p}"] = {"wrapper_ms": statistics.median(walls),
                                  "kernel_ms": sum(kernel_us) / reps / 1e3 if kernel_us else None}
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", tree], check=True)


if __name__ == "__main__":
    main()
