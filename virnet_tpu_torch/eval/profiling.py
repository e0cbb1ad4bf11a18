"""The port's tracing (counterpart of virnet_tpu/eval/profiling.py): named
spans and launch counts inside the program, recorded while a
torch.profiler session records, and ``trace()``, which runs such a
session around a block and writes what it recorded.

How spans turn on.  ``span(name)`` reads one flag that torch.profiler sets
for as long as any session records (``torch.autograd.profiler.
_is_profiler_enabled``: ``trace()`` below, a benchmark's traced tail, an
operator's own ``torch.profiler.profile``, whatever its activities).  With
no session recording it returns one shared no-op context: nothing is
recorded, allocated or synchronised.  There is no flag of its own.

What a span records while a session records: a ``record_function`` range
of its name, so that it shows as a user annotation in the profiler's own
trace beside the kernels; host start and end (``time.perf_counter_ns``);
a pair of timing CUDA events on the current stream, taken from a pool and
never waited on while the span runs (only when the program has
initialised CUDA); and the increase of the hand-written kernels' launch
count (``ops/fused_conv.LAUNCHES``, summed) inside it.  Each ``Record``
holds its ``name``, its ``parent`` span's id (None for a root: a span
opened with no other open in its thread), the ``call`` id that every span
of one root call shares, ``host_start`` / ``host_end`` and ``card_start``
/ ``card_end`` (ns on the host's ``perf_counter`` clock; card times None
off the card) and ``launches``.  Records stay in memory, at most
``LIMIT`` of them; later spans are counted in ``dropped()`` and not kept.

The clock anchor.  ``records()`` synchronises, records an anchor event on
the idle card between two readings of the host clock and synchronises
again; the anchor ran at the middle of the two readings (within half the
``record()`` call and a launch latency, a few us), and a card event that
ran ``d`` ms before it is placed at that host time less ``d``.  So host
and card times of every span are on one clock: ``queue_ms`` (card end less
host end) is how far the card's work ran behind the host when the span
closed.

``summary()`` sums the records by name (count, host and self host ms,
card and self card ms, launches, and the root calls the name occurs in;
self time is the duration less what the span's children cover).
``call_values`` / ``call_median`` give one number a root call, for the
benchmark's per-layer readers (``portbench/metrics/``).

``trace(log_dir)`` writes ``<log_dir>/trace.json`` (the profiler's Chrome
trace, viewable in Perfetto or chrome://tracing, with the spans as user
annotations on the kernels' clock) and ``<log_dir>/spans.json`` (the
block's records and their summary)::

    with trace("runs/trace") as prof:
        restorer.restore_batch(x)

Timing that ends in a synchronisation is eval/analysis.py:measure_time.
"""

from __future__ import annotations

import itertools
import json
import statistics
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import ProfilerActivity, profile, record_function

from ..ops import fused_conv

LIMIT = 100_000      # records kept; later spans are only counted

_records: list = []
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_calls = itertools.count()
_pool: list = []     # timing events free for the next spans


@dataclass
class Record:
    id: int
    name: str
    parent: Optional[int]
    call: int
    host_start: int
    host_end: Optional[int] = None
    card_start: Optional[float] = None
    card_end: Optional[float] = None
    launches: int = 0
    _events: Optional[tuple] = field(default=None, repr=False)

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if not f.name.startswith("_")}


class _Off:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _launches() -> int:
    return sum(fused_conv.LAUNCHES.values())


def _event():
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "rec", "range", "launches0", "events")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        rec = Record(next(_ids), self.name,
                     None if parent is None else parent.id,
                     next(_calls) if parent is None else parent.call, 0)
        with _lock:
            kept = len(_records) < LIMIT
            if kept:
                _records.append(rec)
            else:
                _dropped += 1
        self.rec = rec
        stack.append(rec)
        self.range = record_function(self.name)
        self.range.__enter__()
        self.launches0 = _launches()
        self.events = None
        if kept and torch.cuda.is_initialized():
            self.events = (_event(), _event())
            self.events[0].record()
        rec.host_start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.host_end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
            rec._events = self.events
        rec.launches = _launches() - self.launches0
        self.range.__exit__(*exc)
        _local.stack.pop()
        return False


def span(name: str):
    """A named region of the program: the shared no-op unless a
    torch.profiler session records (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def clear() -> None:
    """Forget every record and the count of dropped spans."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def dropped() -> int:
    """Spans not kept because ``LIMIT`` records were held."""
    return _dropped


def _anchor():
    """(host ns, event): an event recorded on the idle card and the host
    clock when it ran, the middle of the host's ``record()`` call, of the
    three tries the one whose call was shortest (the first record of a
    fresh event also creates it)."""
    tries = []
    for _ in range(3):
        ev = _event()
        torch.cuda.synchronize()
        h0 = time.perf_counter_ns()
        ev.record()
        h1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        tries.append((h1 - h0, (h0 + h1) // 2, ev))
    tries.sort(key=lambda t: t[0])
    _pool.extend(t[2] for t in tries[1:])
    return tries[0][1], tries[0][2]


def records() -> list:
    """Every kept record of a closed span, its card times placed on the
    host's clock (one synchronisation and an anchor event, the first time
    a record is asked for after its span closed)."""
    with _lock:
        done = [r for r in _records if r.host_end is not None]
    pending = [r for r in done if r._events is not None]
    if pending:
        h, anchor = _anchor()
        for r in pending:
            start, end = r._events
            r.card_start = h - start.elapsed_time(anchor) * 1e6
            r.card_end = h - end.elapsed_time(anchor) * 1e6
            r._events = None
            _pool.extend((start, end))
        _pool.append(anchor)
    return done


def _ms(a, b):
    return None if a is None or b is None else (b - a) / 1e6


def host_ms(r: Record) -> float:
    return _ms(r.host_start, r.host_end)


def card_ms(r: Record):
    return _ms(r.card_start, r.card_end)


def queue_ms(r: Record):
    """How far the card's work ran behind the host when the span closed:
    card end less host end, in ms (None off the card)."""
    return _ms(r.host_end, r.card_end)


FIELDS = {"host_ms": host_ms, "card_ms": card_ms, "queue_ms": queue_ms,
          "launches": lambda r: r.launches}


def summary(recs=None) -> dict:
    """By name: ``count``, ``host_ms``, ``self_host_ms``, ``card_ms``,
    ``self_card_ms`` (None off the card), ``launches`` and ``calls`` (the
    root calls the name occurs in)."""
    recs = records() if recs is None else recs
    child_host: dict = {}
    child_card: dict = {}
    for r in recs:
        if r.parent is not None:
            child_host[r.parent] = child_host.get(r.parent, 0.0) + host_ms(r)
            c = card_ms(r)
            if c is not None:
                child_card[r.parent] = child_card.get(r.parent, 0.0) + c
    out: dict = {}
    for r in recs:
        s = out.setdefault(r.name, dict(
            count=0, host_ms=0.0, self_host_ms=0.0, card_ms=None,
            self_card_ms=None, launches=0, calls=set()))
        s["count"] += 1
        s["host_ms"] += host_ms(r)
        s["self_host_ms"] += host_ms(r) - child_host.get(r.id, 0.0)
        c = card_ms(r)
        if c is not None:
            s["card_ms"] = (s["card_ms"] or 0.0) + c
            s["self_card_ms"] = ((s["self_card_ms"] or 0.0) + c
                                 - child_card.get(r.id, 0.0))
        s["launches"] += r.launches
        s["calls"].add(r.call)
    for s in out.values():
        s["calls"] = len(s["calls"])
    return out


def call_values(quantity: str, name: Optional[str] = None,
                roots=None) -> list:
    """One number a root call, in call order: ``quantity`` (a key of
    ``FIELDS``) of the root span itself when ``name`` is None, else summed
    over the call's spans of that name (calls without one are left out).
    ``roots``: the root spans' names to take (default every root); a
    span whose ``quantity`` is None (card times off the card) gives nothing."""
    recs = records()
    get = FIELDS[quantity]
    calls = {r.call: r for r in recs if r.parent is None
             and (roots is None or r.name in roots)}
    sums: dict = {}
    for r in recs:
        if r.call not in calls:
            continue
        if (r.parent is None) if name is None else (r.name == name):
            v = get(r)
            if v is not None:
                sums[r.call] = sums.get(r.call, 0) + v
    return [sums[c] for c in calls if c in sums]


def call_median(quantity: str, name: Optional[str] = None, roots=None):
    """The median over root calls of ``call_values``, or None where there
    is nothing to read."""
    values = call_values(quantity, name, roots)
    return statistics.median(values) if values else None


@contextmanager
def trace(log_dir):
    """Profile the block (the card's kernels too, when there is one) and
    write ``<log_dir>/trace.json`` and ``<log_dir>/spans.json`` (module
    docstring); yields the profiler (``key_averages()`` for sums by
    kernel)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = next(_ids)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    recs = [r for r in records() if r.id > first]
    (log_dir / "spans.json").write_text(json.dumps(dict(
        records=[r.as_dict() for r in recs], summary=summary(recs),
        dropped=dropped()), indent=1))
