"""The configuration's bound per fit (the larger of its float32 operations
over the peak rate and its bytes over HBM bandwidth, ``counts/<config>.py``)
over the device busy time per fit (%). It reads the same work whatever
kernels implement it."""

from bench_torch.peaks import bound_s


def read(run):
    traced = [t for t in run.traces if t.n_ops]
    if not traced:
        return None
    busy = sum(t.busy_s for t in traced) / len(traced)
    return 100.0 * bound_s(run.flop, run.bytes, run.precision) / busy
