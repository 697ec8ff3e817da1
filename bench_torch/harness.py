"""One run of one cell: set-up, the measured window, the check, the result line.

Everything that belongs to one configuration, traffic mix or metric is found
by its name in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the workload's configuration entry names the
  file): sizes, hyperparameters, ``model`` and ``reference`` (the modules
  ``models/<model>.py``, which builds the program's MCMC and the data, and
  ``reference/<reference>.py``, the plain reference), ``precision`` and the
  limits of the check; optionally ``check``, the name of the configuration's
  own check (``checks/<check>.py``, see :func:`load_cell`), else ``check.py``;
- ``counts/<config>.py``: the float32 operations and bytes of one fit,
  ``fit(cfg)``, or where the work follows what a fit draws, ``fit_drawn(cfg,
  outputs)``, taken from each fit's outputs;
- ``traffic/<traffic>.json``: the engine, same or fresh data, and how many
  fits the check samples;
- ``metrics/<metric>.py``: a ``read(run)`` that returns the metric or None.

The loop is closed: one client fits back to back. A fit is one
``MCMC.run(...)`` on a new seed, timed by the host clock from the call to a
``torch.cuda.synchronize()`` after it; between fits, outside that timing, the
benchmark computes the fit's ESS and keeps host copies of the fits the check
samples.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bench_torch import check, trace
from bench_torch.ess import ess_per_column

HERE = Path(__file__).resolve().parent
MASK31 = 0x7FFFFFFF


def load_module(path: Path):
    """A Python file of the benchmark, loaded by its path (once a process)."""
    name = f"bench_torch_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@dataclass
class Cell:
    """A workload and everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    model: object
    reference: object
    counts: object
    metrics: list  # (BENCHMARK.json entry, reader module)
    check: object = check


def load_cell(root: Path, name: str, trace_on: bool) -> Cell:
    """Find the workload ``name`` in ``root/BENCHMARK.json`` and load its files;
    the metrics are the end-to-end ones, or with ``trace_on`` the per-layer
    ones, that this workload reports.

    The check is the configuration's own where its file names one
    (``"check": "<name>"``): ``checks/<name>.py``, which has what ``check.py``
    has, ``NUMBERS``, ``reference_for(cell, cfg, data, device)``,
    ``readings(outputs, reference, device)`` and ``control_outputs(reference,
    precision, chains, keep, generator)``; else ``check.py``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    wl = work[name]
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = [(m, load_module(reader_path(m["name"]))) for m in bench[kind] if name in m.get("workloads", [name])]
    return Cell(name=name, chips=wl["chips"], config_name=wl["config"], config=config, traffic=traffic,
                model=load_module(HERE / "models" / f"{config['model']}.py"),
                reference=load_module(HERE / "reference" / f"{config['reference']}.py"),
                counts=load_module(HERE / "counts" / f"{wl['config']}.py"), metrics=metrics,
                check=load_module(HERE / "checks" / f"{config['check']}.py") if "check" in config else check)


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``; a metric named ``<quantity>.<config>`` without a
    file of its own (the quantity split by configuration, each part with its
    own bound and cells) is read by ``metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    return path if path.exists() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed drawn from the run's seed and a path of integers."""
    return int(np.random.SeedSequence([seed % 2**64, *path]).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    precision: str
    sweeps: int    # per fit
    flop: float    # the configuration's float32 operations per fit (with ``fit_drawn``, the window's mean)
    bytes: float   # and bytes
    walls: list = field(default_factory=list)
    ess: list = field(default_factory=list)
    traces: list = field(default_factory=list)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(root: Path, name: str, seed: int, seconds: float, trace_on: bool, device="cuda", overrides=None,
            start: float = None):
    """Run the cell; returns its result line and the :class:`Run` the metrics
    read. ``overrides`` replace configuration values (the CPU rehearsal's small
    sizes), ``start`` is the process's start on the ``time.perf_counter`` clock."""
    start = time.perf_counter() if start is None else start
    cell = load_cell(root, name, trace_on)
    cfg = {**cell.config, **(overrides or {})}
    import openmcmc_tpu_torch  # noqa: F401  (the program; sets its float32 matmul invariant)

    device = torch.device(device)
    engine, traffic = cell.traffic["engine"], cell.traffic

    def new_data(root_seed, *path):
        gen = torch.Generator(device=device).manual_seed(sub_seed(root_seed, *path))
        return cell.model.make_data(cfg, gen, device)

    if traffic["data"] == "pool":
        # the same set of datasets for every seed, fitted in turn in an order drawn from the seed
        models = [(d, cell.model.build(cfg, d, device))
                  for d in (new_data(traffic["data_seed"], 0, k) for k in range(traffic["datasets"]))]
        order = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 6])).permutation(len(models))
    else:  # "fresh": new data from the seed before every fit, on one model
        first = new_data(seed, 0)
        models, order = [(first, cell.model.build(cfg, first, device))], [0]

    def timed(window, mcmc):
        def fit():
            result = mcmc.run(engine=engine)
            _sync(device)
            return result

        if window is not None:
            return window.fit(fit)
        t0 = time.perf_counter()
        result = fit()
        return result, time.perf_counter() - t0

    # set-up: a warm fit of each model (the matches, the kernel library, the eigenbases;
    # traced, the profiler too) and the ESS
    with trace.Window(device.type) if trace_on else contextlib.nullcontext() as window:
        for k, (_, mcmc) in enumerate(models):
            mcmc.seed = sub_seed(seed, 4, k) & MASK31
            warm, _ = timed(window, mcmc)
    if trace_on:
        window.traces()
    float(torch.mean(ess_per_column(cell.model.outputs(warm)["x"])))
    del warm
    gc.collect()

    span = int(traffic["check_span"])
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 3]))
    picks = rng.choice(np.arange(1, span), size=min(int(traffic["check_fits"]) - 1, span - 1), replace=False)
    checked_at = {0, *(int(i) for i in picks)}
    drawn = getattr(cell.counts, "fit_drawn", None)
    flop, n_bytes = cell.counts.fit(cfg) if drawn is None else (0.0, 0.0)
    run = Run(setup_s=0.0, precision=cfg["precision"], sweeps=cfg["n_burn"] + cfg["n_iter"], flop=flop, bytes=n_bytes)
    kept = []  # (fit index, data, host copies of the fit's outputs)
    i = 0
    window_start = time.perf_counter()
    run.setup_s = window_start - start
    with trace.Window(device.type) if trace_on else contextlib.nullcontext() as window:
        while time.perf_counter() - window_start < seconds:
            data, mcmc = models[order[i % len(models)]]
            if traffic["data"] == "fresh":
                data = new_data(seed, 2, i)
                cell.model.set_data(mcmc, data)
            mcmc.seed = sub_seed(seed, 1, i) & MASK31
            result, wall = timed(window, mcmc)
            outputs = cell.model.outputs(result)
            run.walls.append(wall)
            run.ess.append(float(torch.mean(ess_per_column(outputs["x"]))))
            if drawn is not None:
                fit_flop, fit_bytes = drawn(cfg, outputs)
                flop, n_bytes = flop + fit_flop, n_bytes + fit_bytes
            if i in checked_at:
                kept.append((i, data, {k: v.to("cpu", copy=True) for k, v in outputs.items()}))
            del result, outputs
            i += 1
    if drawn is not None and run.walls:
        run.flop, run.bytes = flop / len(run.walls), n_bytes / len(run.walls)
    if trace_on:
        run.traces = window.traces()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del models, mcmc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = cell.check.NUMBERS
    lims = check.limits(cfg, numbers)
    worst = {k: 0.0 for k in numbers}
    failed, refs = 0, {}
    for _, fit_data, outputs in kept:
        key = id(fit_data)
        if key not in refs:
            refs[key] = cell.check.reference_for(cell, cfg, fit_data, device)
        got = cell.check.readings(outputs, refs[key], device)
        failed += not all(check.passes(got[k], lims[k]) for k in numbers)
        for k in numbers:  # the worst over the checked fits; NaN, once read, stays
            worst[k] = worst[k] if worst[k] != worst[k] else (got[k] if got[k] != got[k] else max(worst[k], got[k]))
    correct = failed == 0 and len(kept) > 0

    metrics = {}
    for entry, reader in cell.metrics:
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": len(run.walls), "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        fenced = [t for t in run.traces if t.n_ops]  # a fit whose fence the profiler lost has no trace
        dev["busy_s"] = sum(t.busy_s for t in fenced)
        dev["window_s"] = sum(t.wall_s for t in fenced)
        out["breakdown"] = trace.breakdown(fenced)
        out["traced_fits"] = {"fenced": len(fenced), "unfenced": len(run.traces) - len(fenced)}
    out["checked"] = len(kept)
    out["checks"] = {k: {"value": worst[k], "limit": lims[k]} for k in numbers}
    return out, run


def run_cell(*args, **kwargs) -> dict:
    """:func:`measure`'s result line."""
    return measure(*args, **kwargs)[0]


def report(out: dict) -> None:
    """The checks as the last lines on standard error, then the result as the
    last line of standard output."""
    print(f"checked fits {out['checked']}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
