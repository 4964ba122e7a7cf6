"""Reading a torch.profiler trace: the device's busy time, kernel time by
name and by class, and the idle gaps by what the host was doing.

The class table is frozen here from the port's ``benches/bench_trace.py``
(``CLASSES``) so that later changes to the program cannot move it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

# (class, name fragments), tested in order on the lower-cased event name
CLASSES = (
    ("digit_kernel", ("digit_matmul",)),
    ("collective", ("nccl", "gloo", "all_gather", "allgather", "all_reduce",
                    "allreduce", "c10d", "memcpy")),
    ("gemm", ("gemm", "aten::mm", "aten::addmm", "aten::bmm",
              "aten::matmul", "cutlass", "xmma")),
    ("reduction", ("reduce", "aten::sum", "norm", "aten::dot")),
    ("elementwise", ("elementwise", "aten::mul", "aten::add", "aten::sub",
                     "aten::div", "aten::where", "aten::sqrt",
                     "aten::copy_", "aten::fill_", "aten::zero_")),
)

NAME_CHARS = 96


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


class Spans:
    """The benchmark's own host spans around the calls into each layer:
    (name, start_ns, end_ns) on the wall clock (``time.time_ns``, the
    clock of the profiler's timestamps), kept while ``on``."""

    def __init__(self):
        self.on = False
        self.items = []

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns() if self.on else None
        try:
            yield
        finally:
            if t0 is not None:
                self.items.append((name, t0, time.time_ns()))


def _span_ns(evt):
    if hasattr(evt, "start_ns"):
        return int(evt.start_ns()), int(evt.duration_ns())
    return int(evt.start_us()) * 1000, int(evt.duration_us()) * 1000


class Trace:
    """The device operations of one profiled window and the host spans
    around them.

    ``ops``: (name, start_ns, duration_ns) of each kernel, copy and memset
    on the card, read from the profiler's raw events (device type CUDA;
    the window is profiled with CUDA activity alone, so no host operator
    is recorded and nothing is parsed into a tree); ``spans``: the
    benchmark's ``Spans``; ``t0_ns``, ``t1_ns``: the traced window on the
    wall clock."""

    def __init__(self, prof, spans, t0_ns: int, t1_ns: int):
        from torch.autograd import DeviceType
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.spans = list(spans)
        self.ops = []
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() == DeviceType.CUDA:
                start, dur = _span_ns(evt)
                self.ops.append((evt.name(), start, dur))

    def clock_offsets_ms(self):
        """(first operation's start - window start, window end - last
        operation's end), ms: both small and positive when the profiler's
        clock is the wall clock of the spans."""
        if not self.ops:
            return None
        first = min(s for _, s, _ in self.ops)
        last = max(s + d for _, s, d in self.ops)
        return [(first - self.t0_ns) / 1e6, (self.t1_ns - last) / 1e6]

    def kernel_count(self, fragment: str = "") -> int:
        """Device operations whose name holds `fragment` (all with "")."""
        return sum(1 for n, _, _ in self.ops if fragment in n.lower()
                   and "memcpy" not in n.lower()
                   and "memset" not in n.lower())

    def device_seconds(self, fragment: str) -> float:
        return sum(d for n, _, d in self.ops if fragment in n.lower()) / 1e9

    def _union(self):
        """Sorted, merged busy intervals of the device, ns."""
        if not self.ops:
            return np.zeros((0, 2), dtype=np.int64)
        iv = np.array([(s, s + d) for _, s, d in self.ops], dtype=np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        reach = np.maximum.accumulate(iv[:, 1])
        first = np.ones(len(iv), dtype=bool)
        first[1:] = iv[1:, 0] > reach[:-1]
        starts = iv[first, 0]
        ends = reach[np.r_[np.nonzero(first)[0][1:] - 1, len(iv) - 1]]
        return np.stack([starts, ends], axis=1)

    def busy_s(self) -> float:
        u = self._union()
        return float(np.sum(u[:, 1] - u[:, 0])) / 1e9 if u.size else 0.0

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time."""
        acc = defaultdict(float)
        for n, _, d in self.ops:
            acc[n[:NAME_CHARS]] += d / 1e9
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]

    def device_classes(self):
        """{class: seconds} of the device time."""
        acc = defaultdict(float)
        for n, _, d in self.ops:
            acc[classify(n)] += d / 1e9
        return dict(sorted(acc.items(), key=lambda kv: -kv[1]))

    def idle_gaps(self, top: int = 10):
        """[[host span, seconds]]: the device's idle time between its
        operations, each gap given to the innermost host span that holds
        the gap's middle, summed by span name."""
        u = self._union()
        if len(u) < 2:
            return []
        gaps = np.stack([u[:-1, 1], u[1:, 0]], axis=1)
        mids = (gaps[:, 0] + gaps[:, 1]) // 2          # ascending
        owner = np.full(len(mids), -1, dtype=np.int64)
        spans = sorted(self.spans, key=lambda s: s[2] - s[1])
        for k, (_, s, e) in enumerate(spans):
            part = owner[np.searchsorted(mids, s, "left"):
                         np.searchsorted(mids, e, "right")]
            part[part < 0] = k
        acc = defaultdict(float)
        for k, g in zip(owner, (gaps[:, 1] - gaps[:, 0]) / 1e9):
            name = spans[k][0] if k >= 0 else "outside the benchmark's spans"
            acc[name[:NAME_CHARS]] += float(g)
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                [:top]]


def idle_pct(trace):
    """100 (1 - busy / wall) of a traced window, or None untraced."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
