"""Wall-clock phase timers (SF_TIMER equivalent: start_timer/stop_timer
used around every expensive phase, e.g. ED_DIAG.f90:64,250), and the
program's spans and counters.

Spans and counters record only while a ``torch.profiler`` session is
recording (the ``record_function`` idiom: no knob of their own). Off, a
``span`` or ``count`` costs one check of the profiler's flag: no
allocation, no CUDA event, no append. On, a span records its name, its
parent's index, its root (the index of the outermost span above it, shared
by every span of one solve), its host start and end on ``time.time_ns``
(the clock of the profiler's device timestamps) and, where it is given a
CUDA tensor or device and the stream is not capturing a graph, a timing
event at entry and at exit on the stream that was that device's current
one when the root's spans first asked for it (one stream lookup per
device and root). The device seconds between the two are read lazily, by
``totals``, after the caller's own synchronise; read events go back to a
pool that later spans take theirs from. Everything stays in ``STORE``
until ``reset()``; spans assume one recording thread.

An operator reads them by running under the profiler and summing by
name::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        solver.solve(...)
    timer.totals()     # {name: {"spans", "host_s", "device_s"} or {"count"}}

and ``timer.intervals()`` gives the spans' host intervals by name.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = nullcontext()
_POOL = []          # timing events whose readings were taken, for reuse


def recording() -> bool:
    """True while a torch.profiler session is recording."""
    return _profiler._is_profiler_enabled


class Span:
    """One recorded span; ``t1`` is None while it is open, ``ev0``/``ev1``
    its timing events until ``device_s`` reads them (None off the card),
    ``dev`` the device seconds read."""
    __slots__ = ("name", "parent", "root", "t0", "t1", "ev0", "ev1", "dev")

    def __init__(self, name, parent, root, t0, ev0):
        self.name, self.parent, self.root = name, parent, root
        self.t0, self.t1, self.ev0, self.ev1 = t0, None, ev0, None
        self.dev = None

    def device_s(self) -> Optional[float]:
        """Device seconds between the entry and exit events, or None
        without events. The first call waits for the exit event, reads
        both and gives them back to the pool."""
        if self.ev1 is not None:
            self.ev1.synchronize()
            self.dev = self.ev0.elapsed_time(self.ev1) / 1e3
            _POOL.extend((self.ev0, self.ev1))
            self.ev0 = self.ev1 = None
        return self.dev


class Store:
    """The spans (in start order) and counters recorded; ``counts`` maps
    (name, root index or -1 outside any span) to the summed increments;
    ``open`` holds the indices of the open spans, innermost last;
    ``streams`` the stream each device's spans time under the open
    root."""

    def __init__(self):
        self.spans = []
        self.reset()

    def reset(self) -> None:
        for s in self.spans:
            _POOL.extend(e for e in (s.ev0, s.ev1) if e is not None)
        self.spans = []
        self.counts: Dict[tuple, int] = {}
        self.open = []
        self.streams = {}


STORE = Store()


def _stream(where):
    """The stream a span on `where` times (a tensor or device; None: the
    current CUDA device once CUDA is initialised): that device's current
    stream when it was first asked for under the open root, or None off
    the card or while the current stream captures a graph."""
    if where is None:
        if not torch.cuda.is_initialized():
            return None
        dev = torch.cuda.current_device()
    else:
        dev = where.device if isinstance(where, torch.Tensor) \
            else torch.device(where)
        if dev.type != "cuda":
            return None
        dev = dev.index
    if torch.cuda.is_current_stream_capturing():
        return None
    s = STORE.streams.get(dev)
    if s is None:
        s = STORE.streams[dev] = torch.cuda.current_stream(dev)
    return s


def _event(stream):
    ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Open:
    """A span being recorded (the context ``span`` returns while on)."""
    __slots__ = ("name", "where", "rec", "stream")

    def __init__(self, name, where):
        self.name, self.where = name, where

    def __enter__(self):
        st = STORE
        if st.open:
            parent = st.open[-1]
            root = st.spans[parent].root
        else:
            parent = -1
            root = len(st.spans)
            st.streams = {}
        self.stream = _stream(self.where)
        ev0 = None if self.stream is None else _event(self.stream)
        self.rec = Span(self.name, parent, root, time.time_ns(), ev0)
        st.open.append(len(st.spans))
        st.spans.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        if self.stream is not None:
            self.rec.ev1 = _event(self.stream)
        self.rec.t1 = time.time_ns()
        STORE.open.pop()
        return False


def span(name: str, where=None):
    """A context that records a span of `name` while the profiler records
    (device time on `where`'s device: a tensor or a device; None takes the
    current CUDA device once CUDA is initialised), and does nothing
    otherwise."""
    return _Open(name, where) if _profiler._is_profiler_enabled else _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (under the innermost open span's root)
    while the profiler records."""
    if _profiler._is_profiler_enabled:
        st = STORE
        key = (name, st.spans[st.open[-1]].root if st.open else -1)
        st.counts[key] = st.counts.get(key, 0) + n


def reset() -> None:
    STORE.reset()


def roots(name: Optional[str] = None, t0_ns: int = 0,
          t1_ns: Optional[int] = None) -> set:
    """Indices of the closed root spans (of `name`, when given) that
    started and ended inside [t0_ns, t1_ns] on time.time_ns."""
    hi = float("inf") if t1_ns is None else t1_ns
    return {i for i, s in enumerate(STORE.spans)
            if s.parent < 0 and s.t1 is not None and t0_ns <= s.t0
            and s.t1 <= hi and (name is None or s.name == name)}


def _closed(root, t0_ns, t1_ns):
    """The closed spans, or with `root`, `t0_ns` or `t1_ns` those under the
    roots ``roots(root, t0_ns, t1_ns)`` selects (the roots included); and
    that selection (None for all)."""
    sel = None if root is None and t0_ns == 0 and t1_ns is None \
        else roots(root, t0_ns, t1_ns)
    return [s for s in STORE.spans if s.t1 is not None
            and (sel is None or s.root in sel)], sel


def intervals(root: Optional[str] = None, t0_ns: int = 0,
              t1_ns: Optional[int] = None) -> list:
    """[(name, host start, host end)] on time.time_ns of the spans
    ``totals`` sums for the same arguments, in start order."""
    return [(s.name, s.t0, s.t1) for s in _closed(root, t0_ns, t1_ns)[0]]


def totals(root: Optional[str] = None, t0_ns: int = 0,
           t1_ns: Optional[int] = None) -> dict:
    """The store summed by name: {span name: {"spans": n, "host_s": s,
    "device_s": s or None}} and {counter name: {"count": n}}, over every
    closed span and counter, or with `root`, `t0_ns` or `t1_ns` over those
    under the roots ``roots(root, t0_ns, t1_ns)`` selects (the roots
    included). Reads the device events, so call it after a synchronise."""
    spans, sel = _closed(root, t0_ns, t1_ns)
    out: Dict[str, dict] = {}
    for s in spans:
        acc = out.setdefault(s.name, {"spans": 0, "host_s": 0.0,
                                      "device_s": None})
        acc["spans"] += 1
        acc["host_s"] += (s.t1 - s.t0) / 1e9
        dev = s.device_s()
        if dev is not None:
            acc["device_s"] = (acc["device_s"] or 0.0) + dev
    for (name, r), n in STORE.counts.items():
        if sel is None or r in sel:
            acc = out.setdefault(name, {"count": 0})
            acc["count"] += n
    return out


class Timers:
    """Accumulating named timers; each stage also opens a span of its
    name."""

    def __init__(self, log=None):
        self.log = log
        self.acc: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def __call__(self, name: str, announce: bool = False):
        if announce and self.log:
            self.log(f"{name} ...")
        t0 = time.time()
        try:
            with span(name):
                yield
        finally:
            dt = time.time() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if announce and self.log:
                self.log(f"{name} done in {dt:.3f}s")

    def snapshot(self) -> Dict[str, float]:
        """Copy of the accumulated seconds per stage (for per-iteration
        deltas in benches — bench_e2e.py's stage table)."""
        return dict(self.acc)

    def report(self) -> str:
        lines = ["timing summary:"]
        for k in sorted(self.acc, key=lambda k: -self.acc[k]):
            lines.append(f"  {k:<28s} {self.acc[k]:9.3f}s "
                         f"({self.counts[k]} calls)")
        return "\n".join(lines)
