"""The traced window's fences: each fit gets its own device operations, and a
fit whose fence record the profiler lost goes without a trace, the others
keeping theirs."""

import pytest

from bench_torch import trace

OFFSET_NS = 123_456_789  # the device clock less the host's


def fake_session(walls, lost):
    """Device events of fits of the given walls (s), each an opening fence, one
    kernel and a closing fence, with the fences in ``lost`` dropped; and the
    host's launch times of the opening fences."""
    events, opens, t = [], [], 0
    for i, wall in enumerate(walls):
        opens.append(t - OFFSET_NS - 7_000)
        span = int(wall * 1e9)
        if ("open", i) not in lost:
            events.append((trace.MARKER, t, t + 600))
        events.append((f"kernel_{i}", t + 2_000, t + span - 2_000))
        if ("close", i) not in lost:
            events.append((trace.MARKER, t + span, t + span + 11_000))
        t += span + 3_000_000 + (i * 7_919) % 500_000
    return events, opens


@pytest.mark.parametrize("lost", [
    set(), {("open", 0)}, {("close", 4)}, {("close", 4), ("open", 5)}, {("close", 9)},
    {("open", 2), ("open", 6), ("close", 7)},
], ids=lambda lost: "-".join(f"{k}{i}" for k, i in sorted(lost)) or "none")
def test_each_fit_gets_its_own_operations(monkeypatch, lost):
    walls = [0.013 + 0.001 * (i % 3) for i in range(10)]
    events, opens = fake_session(walls, lost)
    monkeypatch.setattr(trace, "_device_events", lambda prof: events)
    window = trace.Window("cpu")
    window.cuda, window.walls, window.opens = True, walls, opens
    got = window.traces()
    bare = {i for _, i in lost}
    for i, t in enumerate(got):
        assert t.wall_s == walls[i]
        if i in bare:
            assert t.n_ops == 0
        else:
            assert list(t.ops) == [f"kernel_{i}"] and t.busy_s == pytest.approx(walls[i] - 4e-6)
