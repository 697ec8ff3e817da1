"""Spans and counters of the host's work around the kernels (port of
``openmcmc_tpu/utils/profiling.py``).

The JAX package names regions with ``jax.named_scope`` so that its device
profile shows them. A fit of the port is Python around one kernel launch, so
its spans time the host: :func:`trace_annotated` times a region on
``time.perf_counter_ns`` while a recording is open (:func:`record`) and does
nothing otherwise; :func:`count` keeps one process-wide table of integer
totals, always on.

Spans: ``mcmc.run`` (one fit, ``MCMC.run``: every span inside it carries its
``run_id``, and its counters' changes are kept per run), ``mcmc.match``,
``fused.prepare``, ``kernel.<name>`` (a kernel wrapper up to its launch's
return, or the plain version on the CPU), ``mcmc.repackage`` and
``build.library``. Counters: ``mcmc.runs`` (calls of ``MCMC.run``),
``launch.<name>`` (kernel launches), ``h2d.copies`` and ``h2d.bytes``
(host-to-device copies of the fused engines' inputs), ``sync.host_reads``
(reads from the card on the fused smoother's and regression's paths) and
``build.library_ns`` (the kernel library's build and load).

A recording keeps ``clock_offset_ns``, ``time.time_ns()`` less
``time.perf_counter_ns()`` when it starts. ``torch.profiler``'s events carry
``time.time_ns`` timestamps, so ``t0_ns + clock_offset_ns`` puts a span on a
device trace's timeline.

The tracer is single-threaded: spans opened on two threads at once nest
wrongly. ``profile_run`` (a profiler capture around a run) is not ported.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple, Optional

RUN = "mcmc.run"  # the span of one fit

_COUNTS: defaultdict = defaultdict(int)
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_open: list = []  # the open spans, innermost last
_recording: Optional["Recording"] = None


class Span(NamedTuple):
    """One closed span; times on ``time.perf_counter_ns``."""

    span_id: int
    parent_id: Optional[int]
    run_id: Optional[int]  # the enclosing ``mcmc.run``'s span_id
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


@dataclass
class Recording:
    """What :func:`record` gathered: the closed spans in closing order, each
    run's counter changes (``run_id`` -> {name: change}, the counters that
    changed) and the clock offset onto ``time.time_ns``."""

    clock_offset_ns: int
    spans: list = field(default_factory=list)
    runs: dict = field(default_factory=dict)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    _COUNTS[name] += n


def counters() -> dict:
    """A copy of every counter's total."""
    return dict(_COUNTS)


class _OpenSpan:
    __slots__ = ("name", "attrs", "recording", "span_id", "parent_id", "run_id", "before", "t0_ns")

    def __init__(self, name: str, attrs: dict, recording: Recording):
        self.name, self.attrs, self.recording = name, attrs, recording

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent else None
        if self.name == RUN:
            self.run_id, self.before = self.span_id, dict(_COUNTS)
        else:
            self.run_id = parent.run_id if parent else None
        _open.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1_ns = time.perf_counter_ns()
        _open.pop()
        self.recording.spans.append(
            Span(self.span_id, self.parent_id, self.run_id, self.name, self.t0_ns, t1_ns, self.attrs))
        if self.name == RUN:
            self.recording.runs[self.span_id] = {
                k: v - self.before.get(k, 0) for k, v in _COUNTS.items() if v != self.before.get(k, 0)}
        return False


def trace_annotated(name: str, **attrs):
    """A context manager timing the region as span ``name`` with ``attrs``,
    inside the innermost open span. With no recording open it is one shared
    null context: no clock is read and nothing is recorded."""
    if _recording is None:
        return _NULL
    return _OpenSpan(name, attrs, _recording)


def traced(name: str):
    """Decorate a function so that each call is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _recording is None:
                return fn(*args, **kwargs)
            with _OpenSpan(name, {}, _recording):
                return fn(*args, **kwargs)
        return inner
    return wrap


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost open span (nothing when none is open)."""
    if _open:
        _open[-1].attrs.update(attrs)


@contextlib.contextmanager
def record() -> Iterator[Recording]:
    """Record spans inside the block (one recording at a time); yields the
    :class:`Recording`. Write it out after the block, when the timed work is
    done."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    before = time.perf_counter_ns()
    wall = time.time_ns()
    after = time.perf_counter_ns()
    _recording = recording = Recording(clock_offset_ns=wall - (before + after) // 2)
    try:
        yield recording
    finally:
        _recording = None
