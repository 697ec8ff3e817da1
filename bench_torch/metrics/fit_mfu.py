"""The whole fit's share of the card's peak (%): the configuration's float32
operations per fit over the mean traced fit wall time times the peak rate of
the precision the configuration states."""

from bench_torch.peaks import PEAK_FLOP_PER_S


def read(run):
    traced = [t for t in run.traces if t.n_ops]
    if not traced:
        return None
    wall = sum(t.wall_s for t in traced) / len(traced)
    return 100.0 * run.flop / (wall * PEAK_FLOP_PER_S[run.precision])
