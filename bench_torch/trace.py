"""Device activity of the traced fits, from ``torch.profiler``.

The traced window runs in one profiler session that records the card's
activity only (kernels, copies, fills), so the host pays CUPTI's cost per
launch and nothing per PyTorch operation. Each fit is fenced on the device's
own timeline by a short marker kernel launched just before it and a long one
just after its synchronisation (``torch.cuda._sleep`` of 1,000 and 20,000
cycles, outside the fit's timing): the profiler's device clock and the host's
need not agree. What runs between a fit's two fences is the fit's; what runs
between fits (the benchmark's own ESS) is left out. The two lengths tell an
opening fence from a closing one, so where the profiler loses a fence's
record only that fit goes without a trace. Per fit: the device busy time (the union of its operations' intervals),
the operations by name, and the idle gaps, each named by the operation that
ends it; the host-only time from the first fence to the first device operation
and from the last one to the second fence is named as such.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class FitTrace:
    """What the device did during one fit (seconds)."""

    wall_s: float
    busy_s: float = 0.0
    n_ops: int = 0
    ops: dict = field(default_factory=dict)    # device operation name -> seconds
    gaps: dict = field(default_factory=dict)   # idle gap name -> seconds


def _device_events(prof) -> list:
    """(name, start_ns, end_ns) of every device operation in a finished session."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
OPEN_CYCLES, CLOSE_CYCLES = 1000, 20000
CLOSE_NS = 5000  # a fence that spins longer closes a fit: 1,000 cycles take at most 1.5 us, 20,000 at least 10


def reduce(events: list, wall_s: float, start_ns: int, end_ns: int) -> FitTrace:
    """Busy time, operations and idle gaps of one fit's device events, sorted by
    start; the fit lasted ``wall_s`` on the host clock and lies between its
    fences, ``start_ns`` and ``end_ns`` on the device's timeline."""
    out = FitTrace(wall_s=wall_s, n_ops=len(events))
    if not events:
        return out
    ops, gaps = defaultdict(float), defaultdict(float)
    busy, cur_start, cur_end = 0, events[0][1], events[0][2]
    for name, start, end in events:
        ops[name] += (end - start) * 1e-9
        if start > cur_end:
            busy += cur_end - cur_start
            gaps[f"before {name[:80]}"] += (start - cur_end) * 1e-9
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    out.busy_s = busy * 1e-9
    gaps["host only: fit start to first device op"] += max(events[0][1] - start_ns, 0) * 1e-9
    gaps["host only: last device op to fit end"] += max(end_ns - cur_end, 0) * 1e-9
    out.ops, out.gaps = dict(ops), dict(gaps)
    return out


class Window:
    """A profiler session over a window of fits: ``with Window(device_type) as w:``
    then ``w.fit(fn)`` for each fit (``fn`` ends synchronised); after the
    session, ``w.traces()`` gives each fit's :class:`FitTrace`. Off the card the
    session records the CPU and finds no device operation."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = device_type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        self.walls = []
        self.opens = []  # host clock (ns) at each opening fence's launch

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def _fence(self, cycles: int):
        if self.cuda:
            torch.cuda._sleep(cycles)

    def fit(self, fn):
        self.opens.append(time.perf_counter_ns())
        self._fence(OPEN_CYCLES)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        self._fence(CLOSE_CYCLES)
        self.walls.append(wall)
        return out, wall

    def traces(self) -> list:
        """Each fit's :class:`FitTrace`. An opening fence followed by a closing one
        bounds a fit. Where as many pairs as fits are found, the k-th pair is the
        k-th fit's. Where a fence's record was lost, each pair goes to the fit
        whose opening fence the host launched at the pair's device time less
        the clocks' offset (to 1 ms; the offset is the one most pairs agree
        on), and a fit with no pair is left without operations (``n_ops`` 0;
        the metrics leave it out)."""
        if not self.cuda:
            return [FitTrace(wall_s=w) for w in self.walls]
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        fences = [(e[2] - e[1] >= CLOSE_NS, e[1], e[2]) for e in events if MARKER in e[0]]
        pairs = [(a[2], b[1]) for a, b in zip(fences, fences[1:]) if not a[0] and b[0]]
        owner = list(range(len(pairs))) if len(pairs) == len(self.walls) else _owners(pairs, self.opens, self.walls)
        starts = [e[1] for e in events]
        out = [FitTrace(wall_s=w) for w in self.walls]
        for (lo, hi), i in zip(pairs, owner):
            if i is not None:
                inside = events[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]
                out[i] = reduce([e for e in inside if MARKER not in e[0]], self.walls[i], lo, hi)
        return out


def _owners(pairs: list, opens: list, walls: list, tol_ns: int = 1_000_000) -> list:
    """The fit each pair of fences belongs to, or None: the device clock less
    the host's is the same for every true match, so take the offset that most
    pairs and nearby fits agree on to ``tol_ns``, then match each pair to the
    fit launched nearest its opening fence less that offset, where the pair
    lies about that fit's wall time apart."""
    if not pairs or not opens:
        return [None] * len(pairs)
    cands = sorted(lo - opens[i] for k, (lo, _) in enumerate(pairs)
                   for i in range(max(0, k - 3), min(len(opens), k + 4)))
    a = max(range(len(cands)), key=lambda a: bisect.bisect_right(cands, cands[a] + tol_ns) - a)
    group = cands[a:bisect.bisect_right(cands, cands[a] + tol_ns)]
    offset = group[len(group) // 2]
    owner, taken = [], set()
    for lo, hi in pairs:
        t = lo - offset
        i = bisect.bisect_left(opens, t)
        i = min((c for c in (i - 1, i) if 0 <= c < len(opens)), key=lambda c: abs(opens[c] - t))
        ok = (abs(opens[i] - t) <= tol_ns and i not in taken
              and abs((hi - lo) * 1e-9 - walls[i]) <= 5e-4 + 0.05 * walls[i])
        owner.append(i if ok else None)
        taken.add(i)
    return owner


def breakdown(traces: list, top: int = 10) -> dict:
    """The device operations with the most time and the longest idle gaps, summed
    over the traced fits: {"device_ops": [[name, s], ...], "idle_gaps": [...]}."""
    ops, gaps = defaultdict(float), defaultdict(float)
    for t in traces:
        for k, v in t.ops.items():
            ops[k] += v
        for k, v in t.gaps.items():
            gaps[k] += v
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}
