"""Readings from which the check's limits are set (not run by the benchmark).

    python3 bench_torch/calibrate.py --cells <workload> ... --seeds 12 --control-seeds 3 --seconds 3

For each cell, in one process: the lower readings, a run of the cell
(``harness.run_cell``, a short window) on each of ``--seeds`` seeds, every
checked fit's numbers; then the upper readings, the control on each of
``--control-seeds`` seeds at the cell's own size: the plain reference put in
the program's place and computed in the precision below the configuration's
(float32 with TF32 matrix products, for float32 with TF32 off), its draws and
log density judged as the program's are (the configuration's check's
``control_outputs``); and the same in float64 (exact draws, which the check
must pass). Then, on the same seeds, a run of the cell with each planted fault
(``faults.py``, at the model's own fault site where it has one). Every reading is judged by ``check.passes``
against the configuration's limits of its check's numbers, as a run is:
``correct`` in each JSON line, one a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(cell_name: str, seed: int, precision: str, device, overrides=None) -> dict:
    """The check's numbers for exact posterior draws made by the reference in
    ``precision`` (the configuration's check's ``control_outputs``), at the
    cell's size, on the data of the cell's run with ``seed``."""
    import torch

    from bench_torch import harness

    cell = harness.load_cell(ROOT, cell_name, False)
    cfg = {**cell.config, **(overrides or {})}
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, 0))
    data = cell.model.make_data(cfg, gen, device)
    ref = cell.check.reference_for(cell, cfg, data, device)
    draw_gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, 5))
    outputs = cell.check.control_outputs(ref, precision, cfg["n_chains"], cfg["n_iter"], draw_gen)
    return cell.check.readings(outputs, ref, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", nargs="+", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_007)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import check, faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for name in args.cells:
        cell = harness.load_cell(ROOT, name, False)
        lims = check.limits(cell.config, cell.check.NUMBERS)
        for k in range(args.seeds):
            seed = args.first_seed + 1000 * k
            t0 = time.perf_counter()
            out = harness.run_cell(ROOT, name, seed, args.seconds, False, "cuda")
            print(json.dumps({"cell": name, "kind": "program", "seed": seed, "correct": out["correct"],
                              "checked": out["checked"], "fits": out["attempted"],
                              **{k: v["value"] for k, v in out["checks"].items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
        for k in range(args.control_seeds):
            seed = args.first_seed + 1000 * k
            for precision in ("tf32", "float64"):
                t0 = time.perf_counter()
                got = control(name, seed, precision, torch.device("cuda"))
                correct = all(check.passes(got[k], lims[k]) for k in cell.check.NUMBERS)
                print(json.dumps({"cell": name, "kind": f"control_{precision}", "seed": seed, "correct": correct,
                                  **got, "seconds": time.perf_counter() - t0}), flush=True)
            for fault in sorted(faults.FAULTS):
                t0 = time.perf_counter()
                with faults.planted(fault, cell.model):
                    out = harness.run_cell(ROOT, name, seed, args.seconds, False, "cuda")
                print(json.dumps({"cell": name, "kind": f"fault_{fault}", "seed": seed, "correct": out["correct"],
                                  "checked": out["checked"], "failed": out["failed"],
                                  **{k: v["value"] for k, v in out["checks"].items()},
                                  "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
