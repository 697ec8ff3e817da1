"""Reads from the device per fit, each of which waits for it: the program's
``sync.host_reads`` counter over its ``mcmc.runs``. A cached match reads
nothing; set-up's first match of each dataset does."""

from bench_torch import counters


def read(run):
    return counters.per_fit(run, "sync.host_reads")
