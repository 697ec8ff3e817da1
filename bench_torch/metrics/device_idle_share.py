"""Share of the traced fits' wall time in which no operation ran on the
device (%)."""


def read(run):
    traced = [t for t in run.traces if t.n_ops]
    if not traced:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in traced) / sum(t.wall_s for t in traced))
