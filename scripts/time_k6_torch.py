"""Time kernel K6 (csrc/linreg.cu) of one or more trees of the PyTorch/CUDA port
on one NVIDIA GPU, and hold their draws equal.

    python3 scripts/time_k6_torch.py TREE [TREE ...]

Each TREE is a checkout of this repository or an unpacked ``git archive`` of
one; list them in the order to run, for example parent, change, change, parent.
Each runs in a process of its own, which builds that tree's kernels and then
launches ``fused.linreg.linreg_sweeps_kernel`` at each shape below, timed by
CUDA events around the launch (median over the calls). The first shape is the
benchmark's ``linreg_ex3`` fit (example 3's data law, p 2, 4096 chains,
1000 + 1000 sweeps, Gamma(1e-3, 1e-3), lam0 0.01, tau0 1); the others a
100-row regression at p 8 to 16 and the example at 32768 chains. Every shape runs on one seed in
every tree, and the SHA-256 of each output (beta, lam, tau, log_post) is
printed beside its time, so equal digests mean equal draws bit for bit. Prints
the card's name and power limit, one JSON line per tree, then which shapes'
digests differ from the first tree's. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 2**31 + 90001
# (name, p, chains, n_burn, n_keep, timed calls); p 2 is example 3's data
SHAPES = (("ex3", 2, 4096, 1000, 1000, 21), ("p8", 8, 4096, 1000, 1000, 7), ("p9", 9, 4096, 1000, 1000, 5),
          ("p12", 12, 4096, 1000, 1000, 5), ("p16", 16, 4096, 1000, 1000, 3), ("ex3_32768", 2, 32768, 1000, 1000, 5))


def problem(p: int, dev):
    """X (100, p) and y: example 3's for p 2, else an iid normal design."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(p)
    if p == 2:
        x = torch.sort(torch.rand(100, generator=gen)).values
        X = torch.stack([torch.ones(100), x], 1)
        y = X @ torch.tensor([2.0, 0.5]) + 0.1 * torch.randn(100, generator=gen)
    else:
        X = torch.randn(100, p, generator=gen)
        y = X @ torch.randn(p, generator=gen) + 0.5 * torch.randn(100, generator=gen)
    return X.to(dev), y.to(dev)


def worker(tree: str) -> None:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import torch

    from openmcmc_tpu_torch import _build
    from openmcmc_tpu_torch.fused import linreg

    if root not in Path(linreg.__file__).resolve().parents:
        raise RuntimeError(f"imported {linreg.__file__}, not the tree {root}")
    _build.library()
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"tree": tree}
    for name, p, n_chains, n_burn, n_keep, reps in SHAPES:
        X, y = problem(p, dev)
        ones = torch.ones(p, **f32)
        G, c, scal = linreg.sufficient_statistics(X, y, ones, torch.ones(X.shape[0], **f32))
        args = [G, c, ones, torch.zeros(p, **f32), scal, torch.full((n_chains,), 0.01, **f32),
                torch.full((n_chains,), 1.0, **f32)]
        kw = dict(n_obs=float(X.shape[0]), a_lam=1e-3, b_lam=1e-3, a_tau=1e-3, b_tau=1e-3, n_burn=n_burn,
                  n_keep=n_keep, n_thin=1)

        def call():
            return linreg.linreg_sweeps_kernel(SEED, *args, **kw)

        res = call()
        torch.cuda.synchronize()
        digests = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16] for k, v in res.items()}
        del res
        walls = []
        for _ in range(reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(stop))
        out[name] = {"ms": statistics.median(walls), "ms_min": min(walls), "digests": digests}
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
    lines = []
    for tree in sys.argv[1:]:
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", tree], check=True,
                             stdout=subprocess.PIPE, text=True)
        print(run.stdout, end="", flush=True)
        lines.append(json.loads(run.stdout.strip().splitlines()[-1]))
    first = lines[0]
    for other in lines[1:]:
        differ = [name for name, *_ in SHAPES if other[name]["digests"] != first[name]["digests"]]
        print(json.dumps({"tree": other["tree"], "against": first["tree"], "digests_differ": differ}), flush=True)


if __name__ == "__main__":
    main()
