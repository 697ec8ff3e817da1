"""The program's always-on counters (``openmcmc_tpu_torch.utils.profiling``),
read after the run: totals over every ``MCMC.run`` of the process, set-up's
warm fits (each a first match) and the window's alike. Nothing is switched on
to read them, so they cost the run nothing beyond what the program always
counts. A program without the counters (an older commit) reads None, and so
does a run whose device trace holds nothing (the CPU), as for the device
metrics."""

from __future__ import annotations


def totals() -> dict:
    """Every counter's total, or {} where the program keeps none."""
    try:
        from openmcmc_tpu_torch.utils import profiling
    except ImportError:
        return {}
    return profiling.counters()


def per_fit(run, name: str):
    """Counter ``name``'s total over the ``MCMC.run`` calls (``mcmc.runs``), or None."""
    counts = totals()
    if not counts.get("mcmc.runs") or not any(t.n_ops for t in run.traces):
        return None
    return counts.get(name, 0) / counts["mcmc.runs"]
