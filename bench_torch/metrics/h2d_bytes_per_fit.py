"""Bytes copied from the host to the device per fit: the program's
``h2d.bytes`` counter (the fused engines' pageable uploads of their inputs)
over its ``mcmc.runs``."""

from bench_torch import counters


def read(run):
    return counters.per_fit(run, "h2d.bytes")
