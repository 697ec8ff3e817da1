"""Host time per fit (ms): each traced fit's wall time minus the device busy
time inside it (the union of its kernels, copies and fills), mean over fits.
The layer: MCMC.run with fused/dispatch (coercion, match, host preparation,
repackaging) or the generic driver's Python sweep loop."""


def read(run):
    traced = [t for t in run.traces if t.n_ops]
    return 1e3 * sum(t.wall_s - t.busy_s for t in traced) / len(traced) if traced else None
