"""The port's tracer: stage spans of the device step that survive CUDA-graph
replay, host spans on the profiler's clock, and counters of rare events.

Device spans (:func:`device`, :func:`begin` / :func:`end`, :func:`at_grad`)
are stamps on the current stream.  On the card a stamp is a one-thread
kernel (``csrc/spans.cu``) that writes the span's tag and ``%globaltimer``
into a ring in device memory; under a CUDA graph capture the launch is a
node of the graph, so every replay appends its stamps in stream order.  On
the CPU the same calls record ``time.perf_counter_ns``.  Spans nest: a
span's self time is its duration less its children's.  Nothing is stamped
while the tracer is off (:func:`enable`): a graph captured then holds no
stamp, and the trainer captures again when the tracer is switched
(``Trainer._graph_key``).  A backward is split where gradients arrive:
:func:`at_grad` stamps when a tensor's gradient is complete, and an
``autograd.Function``'s backward opens its own span.  The stages are named
where they are stamped (``engine/editing.py``, the models): an editing
step's denoiser call is ``unet``, or under FLUX.1-dev ``dit``, inside which
the transformer stamps ``dit.embed``, ``dit.double`` and ``dit.single``
(``guidance/flux.py``).

Host spans (:func:`span`) wrap host work: the epoch, the pre-pass, a pt
render, a replay's copies and its launch, a capture, a refresh, the loss
fetch, the compaction auto-tune, a checkpoint's snapshot and the wait for
the previous write.  While a ``torch.profiler`` is active each is a
``record_function("cn.<name>")``, tracer on or off.  While the tracer is on
its ``perf_counter_ns`` duration is also summed by name.  With both off a
span costs one check and returns a shared null context.

:data:`counters` are plain host numbers, always kept and only ever added
to: graph captures and their seconds (``capture``, ``capture_s``),
pretrained renders of a pt-cache miss (``pt_render``), occupancy refreshes
(``refresh``), the time ``AsyncSaver`` holds the training thread
(``saver_block``: its snapshots, saves and waits) and its worker's writes
(``saver_write``), the SD guidance's build, weights (drawn or loaded) and
storage cast (``guidance_build``), the UNet's attention calls on the card
that took the plain path (``attention_plain``: f32 or differentiated
inputs, ``guidance/unet.py::attend``), the SD stack's group norms on the card
that took the plain chain (``group_norm_plain``: f32 inputs or weights, or a
weight that trains, ``guidance/layers.py::GroupNorm``); a read of the ring
sets ``dropped_stamps``.

:func:`collect` reads the ring (after a synchronize, one copy from the
card: never inside a dispatch) and returns, by span name, the device
spans' count, total and self ms and the host spans' count and ms, with the
counters.  :func:`add_track` writes the device spans into a Chrome trace
that ``torch.profiler`` exported, as the ``cn spans`` track on the trace's
clock.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16                  # the ring's slots (csrc/spans.cu)
STAMP_KERNEL = "cn_span_stamp_kernel"
TRACK = "cn spans"
PREFIX = "cn."                      # a host span's name in a profiler trace

_NULL = contextlib.nullcontext()
_on = False
_cuda = False                       # stamps go to the card's ring
_lib = None                         # the kernel library, once a stamp went to the card
_ids: dict = {}                     # span name -> id (a stamp's tag is 2·id + end)
_names: list = []                   # id -> span name
_open: list = []                    # ids of the device spans open now, innermost last
_cpu_stamps: list = []              # (tag, ns) of the CPU's stamps
_cpu_dropped = [0]
_host: dict = {}                    # host span name -> [count, ns]
_anchors: dict = {}                 # host span name -> ns of its first begin since reset
counters = {"capture": 0, "capture_s": 0.0, "pt_render": 0, "pt_render_s": 0.0,
            "refresh": 0, "refresh_s": 0.0, "saver_block": 0, "saver_block_s": 0.0,
            "saver_write": 0, "saver_write_s": 0.0, "guidance_build": 0,
            "guidance_build_s": 0.0, "attention_plain": 0, "group_norm_plain": 0,
            "dropped_stamps": 0}


def enable(on: bool = True, device=None) -> None:
    """Switch the tracer on or off.  ``device``: where the stamps go, the
    card (``cuda``: the kernel library is loaded here) or the host (``cpu``);
    by default the card where there is one."""
    global _on, _cuda, _lib
    if on:
        dev = torch.device(device if device is not None
                           else "cuda" if torch.cuda.is_available() else "cpu")
        _cuda = dev.type == "cuda"
        if _cuda and _lib is None:
            from customnerf_torch.ops import kernels
            _lib = kernels.library()
    _on = bool(on)
    _open.clear()


def enabled() -> bool:
    return _on


# ------------------------------------------------------------ device spans
def _id(name: str) -> int:
    i = _ids.get(name)
    if i is None:
        i = _ids[name] = len(_names)
        _names.append(name)
    return i


def _stamp(tag: int) -> None:
    if _cuda:
        err = _lib.cn_span_stamp(tag, torch.cuda.current_stream().cuda_stream)
        if err:
            from customnerf_torch.ops import kernels
            kernels.check(err, "span stamp")
    elif len(_cpu_stamps) < CAPACITY:
        _cpu_stamps.append((tag, time.perf_counter_ns()))
    else:
        _cpu_dropped[0] += 1


def begin(name: str) -> None:
    """Open the device span ``name`` (a stamp on the current stream)."""
    if _on:
        i = _id(name)
        _open.append(i)
        _stamp(2 * i)


def end(name: str) -> None:
    """Close the open device span ``name``, and first every span opened
    inside it that is still open.  Nothing if ``name`` is not open."""
    if not _on:
        return
    i = _id(name)
    if i not in _open:
        return
    while _open:
        j = _open.pop()
        _stamp(2 * j + 1)
        if j == i:
            break


class _DeviceSpan:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        begin(self.name)

    def __exit__(self, *exc):
        end(self.name)


def device(name: str):
    """A device span around a ``with`` block."""
    return _DeviceSpan(name) if _on else _NULL


def at_grad(t: torch.Tensor, ends: str | None = None, begins: str | None = None):
    """Stamp when ``t``'s gradient is complete in a backward: close the
    span ``ends``, then open the span ``begins`` (either may be None).  The
    hook runs during a capture too, so its stamps replay with the graph.
    Returns ``t``."""
    if _on and t.requires_grad:
        t.register_hook(functools.partial(_grad_stamps, ends, begins))
    return t


def _grad_stamps(ends, begins, _grad):
    if ends is not None:
        end(ends)
    if begins is not None:
        begin(begins)


# -------------------------------------------------------------- host spans
class _HostSpan:
    __slots__ = ("name", "counter", "rf", "t0")

    def __init__(self, name, counter):
        self.name, self.counter = name, counter

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns() if _on or self.counter else None
        if _on:
            _anchors.setdefault(self.name, self.t0)
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            ns = time.perf_counter_ns() - self.t0
            if _on:
                h = _host.setdefault(self.name, [0, 0])
                h[0] += 1
                h[1] += ns
            if self.counter:
                count(self.counter, ns * 1e-9)
        if self.rf is not None:
            self.rf.__exit__(*exc)


def span(name: str, counter: str | None = None):
    """A host span around a ``with`` block; ``counter``: the counter it
    bumps, with its seconds added to ``counter + "_s"``, tracer on or
    off."""
    if counter is None and not _on and not _profiler._is_profiler_enabled:
        return _NULL
    return _HostSpan(name, counter)


def count(name: str, seconds: float | None = None) -> None:
    """Add one to the counter ``name`` and ``seconds`` to ``name + "_s"``."""
    counters[name] = counters.get(name, 0) + 1
    if seconds is not None:
        counters[name + "_s"] = counters.get(name + "_s", 0.0) + seconds


# ------------------------------------------------------------------ reading
def reset() -> None:
    """Forget the stamps (the card's ring rewound after a synchronize) and
    the host spans' totals; the counters stay."""
    _cpu_stamps.clear()
    _cpu_dropped[0] = 0
    _host.clear()
    _anchors.clear()
    _open.clear()
    if _lib is not None:
        from customnerf_torch.ops import kernels
        torch.cuda.synchronize()
        kernels.check(_lib.cn_span_reset(), "span reset")


def _card_stamps() -> tuple:
    """([(tag, ns)], dropped) of the card's ring: one copy after a
    synchronize."""
    if _lib is None:
        return [], 0
    from customnerf_torch.ops import kernels
    torch.cuda.synchronize()
    buf = np.zeros(int(_lib.cn_span_ring_bytes()), np.uint8)
    kernels.check(_lib.cn_span_read(buf.ctypes.data), "span read")
    cursor = int(buf[:8].view(np.uint64)[0])
    slots = buf[16:].view(np.dtype([("t", "<u8"), ("tag", "<u4"), ("pad", "<u4")]))
    n = min(cursor, len(slots))
    return (list(zip(slots["tag"][:n].tolist(), slots["t"][:n].tolist())),
            cursor - n)


def _sources() -> list:
    """Each clock's stamps in the order they were taken, with the count
    dropped: ("cpu", stamps, dropped), ("cuda", stamps, dropped)."""
    out = [("cpu", list(_cpu_stamps), _cpu_dropped[0])]
    if _lib is not None:
        out.append(("cuda", *_card_stamps()))
    counters["dropped_stamps"] = sum(d for _, _, d in out)
    return out


def occurrences(stamps) -> list:
    """The spans of a sequence of stamps ``[(tag, ns)]``: (id, index of the
    begin, index of the end, depth, self ns) in the order they close.  A
    begin whose end never came (dropped) is left out, with what it held
    open above it."""
    out, stack = [], []                 # stack: [id, begin index, children's ns]
    for k, (tag, t) in enumerate(stamps):
        i = tag >> 1
        if not tag & 1:
            stack.append([i, k, 0])
            continue
        if not any(s[0] == i for s in stack):
            continue
        while stack[-1][0] != i:
            stack.pop()
        _, k0, child = stack.pop()
        dur = t - stamps[k0][1]
        out.append((i, k0, k, len(stack), dur - child))
        if stack:
            stack[-1][2] += dur
    return out


def _blank() -> dict:
    return {"count": 0, "device_ms": 0.0, "self_ms": 0.0, "host_count": 0, "host_ms": 0.0}


def collect() -> dict:
    """What the tracer recorded since :func:`reset`: ``spans``, by name, the
    device spans' ``count``, ``device_ms`` and ``self_ms`` (the span less
    its children) and the host spans' ``host_count`` and ``host_ms``;
    ``counters`` as they stand; ``stamps`` read."""
    spans, n = {}, 0
    for _, stamps, _ in _sources():
        n += len(stamps)
        for i, k0, k1, _, self_ns in occurrences(stamps):
            s = spans.setdefault(_names[i], _blank())
            s["count"] += 1
            s["device_ms"] += (stamps[k1][1] - stamps[k0][1]) * 1e-6
            s["self_ms"] += self_ns * 1e-6
    for name, (c, ns) in _host.items():
        s = spans.setdefault(name, _blank())
        s["host_count"], s["host_ms"] = c, ns * 1e-6
    return {"spans": spans, "counters": dict(counters), "stamps": n}


def counters_line(since: dict) -> str:
    """The counters less ``since`` (an earlier copy) in one line; the
    guidance's build, which comes before a run, and the dropped stamps as
    they stand."""
    c = {k: v - since.get(k, 0) for k, v in counters.items()}
    for k in ("guidance_build", "guidance_build_s", "dropped_stamps"):
        c[k] = counters[k]
    return (f"[INFO] counters: {c['capture']} graph captures ({c['capture_s']:.3f} s), "
            f"{c['pt_render']} pt renders ({c['pt_render_s']:.3f} s), "
            f"{c['refresh']} occupancy refreshes, checkpoint writer held the "
            f"training thread {c['saver_block_s']:.3f} s over {c['saver_block']} calls "
            f"and wrote {c['saver_write_s']:.3f} s in {c['saver_write']} writes, "
            f"{c['guidance_build']} guidance builds ({c['guidance_build_s']:.3f} s), "
            f"{c['attention_plain']} plain attention calls on the card, "
            f"{c['group_norm_plain']} plain group norms on the card, "
            f"{c['dropped_stamps']} stamps dropped")


# ------------------------------------------------------------------ export
def _anchor(clock, launches, idx, centre: int, shifts: int = 8):
    """(card time, trace clock less the card's) at the stamps ``idx``: the
    index shift within ``shifts`` of ``centre`` whose launch gaps best
    match the stamps' gaps (a launch the profiler lost shifts the pairing),
    and the medians of the pairs whose gaps agree.  None without such
    pairs."""
    best = None
    for s in range(centre - shifts, centre + shifts + 1):
        pairs = [(abs((launches[i + s + 1] - launches[i + s]) - (clock[i + 1] - clock[i])),
                  i, i + s) for i in idx
                 if 0 <= i + s < len(launches) - 1 and i < len(clock) - 1]
        if len(pairs) < 3:
            continue
        err = float(np.median([e for e, _, _ in pairs]))
        if best is None or err < best[0]:
            best = (err, pairs)
    if best is None:
        return None
    good = [(clock[i], launches[j] - clock[i]) for e, i, j in best[1]
            if e <= 0.5 + 2e-3 * (clock[i + 1] - clock[i])]
    if not good:
        return None
    return float(np.median([t for t, _ in good])), float(np.median([o for _, o in good]))


def card_to_trace(clock, launches, tol: float = 1.0, drift: float = 1e-4,
                  block: int = 32) -> list | None:
    """The card's stamp times ``clock`` (µs, in order) on the trace's clock.
    The offset is taken at the first and the last ``block`` stamps
    (:func:`_anchor`) and drawn linearly between them (the two clocks can
    run apart by hundreds of ppm).  Then, in order, each stamp goes on the
    launch of the stamp kernel nearest its time, if within ``tol`` µs plus
    ``drift`` of the time since the last stamp placed, and not nearer the
    next stamp's time (its own launch was lost); the residual of the last
    stamp placed carries to the next.  ``tol`` is under the least time
    between two stamps (≈ 1.75 µs on an H100)."""
    n = len(clock)
    first = _anchor(clock, launches, range(min(block, n)), 0)
    last = _anchor(clock, launches, range(max(0, n - block), n), len(launches) - n)
    if first is None:
        return None
    (t0, o0), (t1, o1) = first, last or first
    slope = (o1 - o0) / (t1 - t0) if t1 > t0 else 0.0
    lin = [c + o0 + slope * (c - t0) for c in clock]
    out, res, j, since = [], 0.0, 0, clock[0]
    for i, x in enumerate(lin):
        x += res
        k = bisect.bisect_left(launches, x, lo=j)
        k = min((c for c in (k - 1, k) if j <= c < len(launches)),
                key=lambda c: abs(launches[c] - x), default=None)
        ok = k is not None and abs(launches[k] - x) <= tol + drift * (clock[i] - since)
        if ok and i + 1 < n:
            ok = abs(launches[k] - x) <= abs(launches[k] - (lin[i + 1] + res))
        if ok:
            res, j, since, x = launches[k] - lin[i], k + 1, clock[i], launches[k]
        out.append(x)
    return out


def _placed(source: str, stamps, events) -> list | None:
    """Each stamp's time on the trace's clock (µs): the card's by
    :func:`card_to_trace` against the trace's launches of the stamp kernel;
    the host's shifted by the offset between the trace's first ``cn.epoch``
    and the tracer's."""
    if source == "cuda":
        launches = sorted(float(e["ts"]) for e in events
                          if e.get("ph") == "X" and e.get("cat") == "kernel"
                          and STAMP_KERNEL in e.get("name", ""))
        if not launches or not stamps:
            return None
        base = stamps[0][1]                # ns since the epoch: keep µs exact
        return card_to_trace([(t - base) * 1e-3 for _, t in stamps], launches)
    epochs = [e["ts"] for e in events
              if e.get("ph") == "X" and e.get("name") == PREFIX + "epoch"]
    if not epochs or "epoch" not in _anchors:
        return None
    offset = float(min(epochs)) - _anchors["epoch"] * 1e-3
    return [t * 1e-3 + offset for _, t in stamps]


def add_track(path: str) -> int:
    """Write the device spans recorded since :func:`reset` into the Chrome
    trace at ``path`` (``torch.profiler``'s export) as the ``cn spans``
    track, placed on the trace's clock (:func:`_placed`), nested as they
    ran; each event's ``args`` give its self time.  Returns the spans
    written."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    added = []
    for source, stamps, _ in _sources():
        ts = _placed(source, stamps, events)
        if not ts:
            continue
        for i, k0, k1, depth, self_ns in occurrences(stamps):
            if k1 >= len(ts):
                continue
            added.append({"ph": "X", "cat": "cn_span", "name": _names[i], "pid": pid,
                          "tid": 0, "ts": ts[k0], "dur": max(ts[k1] - ts[k0], 0.0),
                          "args": {"self_us": self_ns * 1e-3, "depth": depth,
                                   "clock": source}})
    if added:
        added.sort(key=lambda e: (e["ts"], -e["dur"]))
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": TRACK}})
        events.extend(added)
        with open(path, "w") as f:
            json.dump(trace, f)
    return len(added)
