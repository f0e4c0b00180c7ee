"""From a ``torch.profiler`` trace of the traced window to what the
per-layer readers read: the device's busy time as the union of the
intervals in which an operation ran on it (overlapping kernels count once,
so the busy share cannot pass 100 %), the device time of each kernel name,
the longest idle gaps labelled by what the host was doing, and the window's
own bounds (the ``record_function`` span ``WINDOW`` around it).
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

WINDOW = "benchmark.window"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)       # name -> seconds
    kernel_n: dict = field(default_factory=dict)       # name -> launches
    gaps: list = field(default_factory=list)           # [(label, seconds)]

    def seconds(self, *patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(s for k, s in self.kernel_s.items() if any(p in k for p in patterns))

    def top(self, n: int = 10) -> list:
        return sorted(([k[:160], s] for k, s in self.kernel_s.items()),
                      key=lambda kv: -kv[1])[:n]


def union(intervals):
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce(events, n_gaps: int = 10) -> Trace:
    """``events``: (name, on_device, is_annotation, start_ns, end_ns)."""
    window = [(s, e) for n, dev, ann, s, e in events if n == WINDOW and not dev]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0]
    dev, kernel_s, kernel_n = [], collections.defaultdict(float), collections.Counter()
    host = []
    for name, on_dev, ann, s, e in events:
        if on_dev:
            if ann:
                continue
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            dev.append((s, e))
            kernel_s[name] += (e - s) * 1e-9
            kernel_n[name] += 1
        elif name != WINDOW and s < w1 and e > w0:
            host.append((s, e, name))
    busy_ns, merged = union(dev)
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    host.sort()
    starts = [h[0] for h in host]
    labelled = [[_label(host, starts, a, b), (b - a) * 1e-9] for a, b in gaps]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 kernel_s=dict(kernel_s), kernel_n=dict(kernel_n), gaps=labelled)


def _label(host, starts, a, b):
    """The innermost host span covering the gap's middle: annotations of the
    benchmark's own and the port's operations alike."""
    mid = (a + b) / 2
    best = None
    for s, e, name in host[:bisect.bisect_right(starts, mid)]:
        if e >= mid and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host: no span"


def from_profiler(prof) -> Trace:
    from torch.autograd import DeviceType
    rows = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() != DeviceType.CPU
        rows.append((e.name(), on_dev, bool(e.is_user_annotation()), e.start_ns(),
                     e.start_ns() + e.duration_ns()))
    return reduce(rows)
