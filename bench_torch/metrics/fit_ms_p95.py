"""95th percentile of the wall time of every fit in the window (ms)."""

from bench_torch.stats import percentile


def read(run):
    return 1e3 * percentile(run.walls, 95) if run.walls else None
