"""Measuring on the card: the device time of a call, the card's name and
power limit, and the arguments a function of the main path was called with."""

from __future__ import annotations

import collections
import contextlib
import subprocess

import torch

# ~1 ms of sleep a timed call at the H100's ≤ 1.98 GHz: longer than the host
# takes to enqueue any call timed in this repo
SLEEP_CYCLES_PER_CALL = 2_000_000


def device_ms(fn, reps: int, warmup: int = 2, host_ahead: bool = True) -> float:
    """Mean ms of one call between CUDA events around ``reps`` calls.

    ``host_ahead`` (the default) queues the calls behind a sleep kernel that
    lasts longer than the host takes to enqueue them, so the span holds the
    device's work alone.  Without it the host enqueues while the card runs,
    and a call whose kernel is shorter than its Python wrapper measures the
    wrapper."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if host_ahead:
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _detach(a):
    if torch.is_tensor(a):
        return a.detach()
    if isinstance(a, (list, tuple)):
        return type(a)(_detach(x) for x in a)
    return a


@contextlib.contextmanager
def captured_calls(owner, attr: str, keep: int, when=None):
    """Inside the block, ``owner.attr`` runs as before and keeps the
    (detached) arguments and keyword arguments of its last ``keep`` calls in
    the deque this yields — of those calls for which ``when(args, kwargs)``
    is true, when given; it is restored on exit."""
    fn = getattr(owner, attr)
    calls = collections.deque(maxlen=keep)

    def wrapped(*args, **kwargs):
        if when is None or when(args, kwargs):
            calls.append((_detach(args), kwargs))
        return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)
