"""What the per-layer readers (``benchmark/metrics/<name>.py``) share.

A reader takes the traced run (:class:`Traced`) and returns its number, or
None where it finds nothing to read: the harness then leaves the metric
out.  Shares are in %, times in ms.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.lib import counts

K1_KERNELS = ("fused_mlp", "pack_weights")
DT_KERNELS = ("plane_dtable",)


@dataclass
class Traced:
    trace: object                      # lib/trace.Trace of the traced window
    steps: int                         # steps in the traced window
    refreshes: int                     # occupancy refreshes in it
    spans: dict = field(default_factory=dict)      # name -> device ms a step
    work: dict = field(default_factory=dict)       # part -> [(flops, bytes, peak)] a step
    refresh_work: dict = field(default_factory=dict)   # part -> (flops, bytes, peak)
    model_flops: float = 0.0           # a step's model FLOPs


def _least(items) -> float:
    return sum(counts.least_s(f, b, p) for f, b, p in items)


def idle_share(r: Traced):
    t = r.trace
    if not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(r: Traced):
    if not r.trace.window_s or not r.model_flops or not r.steps:
        return None
    return 100.0 * r.model_flops * r.steps / (r.trace.window_s * counts.PEAK_BF16_FLOPS)


def span_ms(r: Traced, name: str):
    return r.spans.get(name)


def span_roofline(r: Traced, name: str):
    ms, work = r.spans.get(name), r.work.get(name)
    if not ms or not work:
        return None
    return 100.0 * _least(work) * 1e3 / ms


def kernel_roofline(r: Traced, part: str, patterns):
    """The least time of every launch of ``part`` in the traced window over
    the device time the trace gives its kernels."""
    measured = r.trace.seconds(*patterns)
    work = r.work.get(part)
    if not measured or not work:
        return None
    least = r.steps * _least(work)
    if part in r.refresh_work:
        least += r.refreshes * _least([r.refresh_work[part]])
    return 100.0 * least / measured
