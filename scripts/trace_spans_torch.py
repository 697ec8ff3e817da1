"""The program's host spans on the card: what the tracer's recording costs, where
a fit's host time goes, and whether its spans sit on the device trace's clock.

    python3 scripts/trace_spans_torch.py --workload smoother_ex4.fused linreg_ex3.fused \
        --seed 1234567890123 --out spans.json

For each benchmark cell, on its pool of datasets (built from the cell's files as
``bench_torch/harness.py`` builds it; one warm fit each first):

1. Cost: blocks of fits with the recording off and on (no profiler),
   alternating, each fit timed from ``MCMC.run`` to a
   ``torch.cuda.synchronize()``; then one recording held open over
   ``--long`` fits, its first and last tenth's median fit wall against the
   off blocks'.
2. Spans: ``bench_torch/trace.py``'s fenced profiler session (device activity
   only) with the recording on. Per fenced fit, the host time as
   ``host_ms_per_fit`` reads it and the mean duration of each span; per
   ``kernel.<name>`` span, its kernel's device start less the span's start
   moved onto the device clock by ``clock_offset_ns`` (the k-th span against
   the k-th device kernel holding ``<name>``), whether the profiler's own
   record of the launch call (the runtime API call it correlates with the
   kernel, on the host) lies inside the span, and the kernel's start less
   that call's: a kernel that starts before its span with its call inside
   the span and before its start is the profiler's device clock, not the
   spans'.

Writes one JSON object to ``--out`` and prints a summary line per cell.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import harness, trace  # noqa: E402
from openmcmc_tpu_torch.utils import profiling  # noqa: E402


def pool(cell, seed, device):
    """The cell's models, each fitted once."""
    def data(k):
        gen = torch.Generator(device=device).manual_seed(harness.sub_seed(cell.traffic["data_seed"], 0, k))
        return cell.model.make_data(cell.config, gen, device)

    models = [cell.model.build(cell.config, data(k), device) for k in range(cell.traffic["datasets"])]
    for k, mcmc in enumerate(models):
        mcmc.seed = harness.sub_seed(seed, 4, k) & harness.MASK31
        mcmc.run(engine=cell.traffic["engine"])
    torch.cuda.synchronize()
    return models


class Fits:
    """Fits over the pool in turn, each with a seed of its own."""

    def __init__(self, models, engine, seed):
        self.models, self.engine, self.seed, self.i = models, engine, seed, 0

    def fn(self):
        mcmc = self.models[self.i % len(self.models)]
        mcmc.seed = harness.sub_seed(self.seed, 8, self.i) & harness.MASK31
        self.i += 1
        return lambda: (mcmc.run(engine=self.engine), torch.cuda.synchronize())

    def walls_ms(self, n):
        out = []
        for _ in range(n):
            fit = self.fn()
            t0 = time.perf_counter()
            fit()
            out.append(1e3 * (time.perf_counter() - t0))
        return out


def cost(fits, blocks, per_block, long):
    walls, ratios = {"off": [], "on": []}, []
    for b in range(blocks):
        med = {}
        for mode in (("off", "on") if b % 2 == 0 else ("on", "off")):
            if mode == "on":
                with profiling.record():
                    block = fits.walls_ms(per_block)
            else:
                block = fits.walls_ms(per_block)
            walls[mode] += block
            med[mode] = statistics.median(block)
        ratios.append(med["on"] / med["off"] - 1.0)
    with profiling.record() as rec:
        held = fits.walls_ms(long)
    tenth = max(1, long // 10)
    off = statistics.median(walls["off"])
    return {"fits_each": len(walls["off"]), "median_ms": {k: statistics.median(v) for k, v in walls.items()},
            "on_over_off": statistics.median(walls["on"]) / off - 1.0,
            "block_pairs_on_over_off": {"median": statistics.median(ratios), "quartiles": statistics.quantiles(ratios, n=4),
                                        "on_slower": sum(r > 0 for r in ratios), "pairs": len(ratios)},
            "held": {"fits": long, "spans": len(rec.spans), "first_tenth_over_off": statistics.median(held[:tenth]) / off - 1.0,
                     "last_tenth_over_off": statistics.median(held[-tenth:]) / off - 1.0}}


def spans(fits, n_fits):
    with profiling.record() as rec, trace.Window("cuda") as window:
        for _ in range(n_fits):
            window.fit(fits.fn())
    traces = window.traces()
    fenced = [t for t in traces if t.n_ops]
    durations = defaultdict(float)
    for s in rec.spans:
        durations[s.name] += 1e-6 * (s.t1_ns - s.t0_ns)
    cuda = torch.autograd.DeviceType.CUDA
    events = list(window.prof.profiler.kineto_results.events())
    calls = {e.correlation_id(): e.start_ns() for e in events if e.device_type() != cuda}  # runtime API calls
    lags, queued, in_span, unpaired = [], [], 0, {}
    for name in sorted({s.name for s in rec.spans if s.name.startswith("kernel.")}):
        kernel = name.split(".", 1)[1]
        mine = sorted((s for s in rec.spans if s.name == name), key=lambda s: s.t0_ns)
        ran = sorted((e for e in events if e.device_type() == cuda and kernel in e.name() and trace.MARKER not in e.name()),
                     key=lambda e: e.start_ns())
        if len(ran) != len(mine):
            unpaired[name] = (len(mine), len(ran))
            continue
        for s, e in zip(mine, ran):
            t0, t1 = s.t0_ns + rec.clock_offset_ns, s.t1_ns + rec.clock_offset_ns
            lags.append(e.start_ns() - t0)
            call = calls.get(e.correlation_id())
            if call is not None:
                in_span += t0 <= call <= t1
                queued.append(e.start_ns() - call)
    lag_us = sorted(1e-3 * v for v in lags)
    return {"fits": n_fits, "fenced": len(fenced),
            "host_ms_per_fit": 1e3 * statistics.mean(t.wall_s - t.busy_s for t in fenced) if fenced else None,
            "span_ms_per_fit": {k: v / n_fits for k, v in sorted(durations.items(), key=lambda kv: -kv[1])},
            "launch_lag_us": {"n": len(lag_us), "negative": sum(v < 0 for v in lag_us),
                              "min": lag_us[0] if lag_us else None,
                              "median": statistics.median(lag_us) if lag_us else None,
                              "p99": float(np.percentile(lag_us, 99)) if lag_us else None},
            "launch_call_in_span": [in_span, len(queued)],
            "start_after_launch_call_us": {"negative": sum(v < 0 for v in queued),
                                           "median": 1e-3 * statistics.median(queued) if queued else None},
            "unpaired": unpaired}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fits", type=int, default=400, help="traced fits per cell (0: none)")
    ap.add_argument("--blocks", type=int, default=10, help="cost blocks per mode")
    ap.add_argument("--per-block", type=int, default=60, help="fits per cost block")
    ap.add_argument("--long", type=int, default=2000, help="fits under one held recording")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(device), "torch": torch.__version__}
    for name in args.workload:
        cell = harness.load_cell(ROOT, name, False)
        fits = Fits(pool(cell, args.seed, device), cell.traffic["engine"], args.seed)
        res = {"cost": cost(fits, args.blocks, args.per_block, args.long),
               "spans": spans(fits, args.fits) if args.fits else {}}
        out[name] = res
        print(name, json.dumps(res), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
