"""Seconds the kernel library took to load (and to build, in a checkout's
first run): the program's ``build.library_ns`` counter, in set-up's first fit."""

from bench_torch import counters


def read(run):
    ns = counters.totals().get("build.library_ns")
    return 1e-9 * ns if ns else None
