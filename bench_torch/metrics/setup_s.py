"""Seconds from process start to the first timed fit: imports, the CUDA
context, the kernel library's load (and build, in a checkout's first run), the
data, and one warm fit with its ESS."""


def read(run):
    return run.setup_s
