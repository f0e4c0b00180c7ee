"""The tracer's split of a benchmark cell's graphed step, and what the tracer
costs there.

    python -m tools.span_split --workload <cell> --seeds N [N ...] \\
        [--seconds 51] [--cost-seconds 0]

Run from the repository root on the card.  For each seed, in one process:
the cell's program as the benchmark builds it (``benchmark/lib/training.py``:
the seed's weights and inputs, the checked steps, the job's set-up), then

1. a window of ``--seconds`` with the tracer off, timed as the benchmark
   times it (``training.window``): the cell's ms a step;
2. the spans epoch: the tracer on (``customnerf_torch/engine/spans.py``),
   one dispatch outside any timed span (the step captured again, with its
   stamps), then one epoch of the traffic's ``epoch_steps`` steps with no
   profiler, and ``spans.collect()``: every span's device ms a step, total
   and self; the refresh in ms a refresh; the host spans in ms a step; the
   step span's own share (what no stage below it covers); the step span
   plus the refreshes spread over the steps, against the window's ms a step;
3. with ``--cost-seconds T`` > 0, four windows of T seconds with the
   tracer off, on, on, off, each after one dispatch outside it (the
   capture): the tracer's cost on the window;
4. with ``--profile-steps N`` > 0, an epoch of N steps through the
   trainer's own ``--profile`` (``Trainer._start_profile`` /
   ``_stop_profile``: ``torch.profiler`` with the tracer on, the ``cn
   spans`` track added to its Chrome trace), captured beforehand, and that
   trace read back: the stamp kernels, the share of the track's span ends
   that sit on one, the share of each span's interval in which a kernel runs, and the longest idle gaps of the
   card with the innermost host range over each (and the innermost
   ``cn.*`` one).  The trace itself is deleted (tens of MB).

Prints one JSON line a seed and writes them all to
``chiprun_out/span_split/<cell>.json``.  Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

STEP_SPANS = ("edit.step", "recon.step")
EDIT = {
    "unet_graphed_ms": (("unet",), ()),
    "vae_encode_graphed_ms": (("vae_encode",), ()),
    "vae_backward_graphed_ms": (("vae_encode.bwd",), ()),
    "render_graphed_ms": (("render",), ()),
    "render_backward_graphed_ms": (("render.bwd",), ()),
    "host_ms": ((), ("pre_pass", "replay.copy", "replay")),
}


def unet_parts(levels: int, text_time: bool = False) -> dict:
    """The UNet's levels (each level's down and up block), its mid block
    and, for SDXL, its text-time embedding."""
    out = {f"unet_level{i}_graphed_ms": ((f"unet.level{i}",), ()) for i in range(levels)}
    out["unet_mid_graphed_ms"] = (("unet.mid",), ())
    if text_time:
        out["unet_text_time_graphed_ms"] = (("unet.text_time",), ())
    return out


# FLUX's transformer: the SDS call, its embedders, its two groups of blocks
DIT = {"dit_graphed_ms": (("dit",), ()), "dit_embed_graphed_ms": (("dit.embed",), ()),
       "dit_double_graphed_ms": (("dit.double",), ()),
       "dit_single_graphed_ms": (("dit.single",), ())}

# per-layer readings of the split, by job: (device spans summed, host spans summed)
READINGS = {
    "edit": {**EDIT, **unet_parts(4)},
    "edit_xl": {**EDIT, **unet_parts(3, text_time=True)},
    "edit_flux": {**{k: v for k, v in EDIT.items() if k != "unet_graphed_ms"}, **DIT},
    "recon": {
        "grid_encode_graphed_ms": (("grid_encode", "grid_encode.bwd"), ()),
        "grid_encode_backward_graphed_ms": (("grid_encode.bwd",), ()),
        "k1_backward_graphed_ms": (("k1.bwd",), ()),
        "host_ms": ((), ("replay.copy", "replay")),
    },
}


def readings(job: str, got: dict, steps: int) -> dict:
    """The split's per-layer numbers, in ms a step (``refresh_ms`` in ms a
    refresh); None where a span never ran."""
    s = got["spans"]
    out = {}
    for name, (dev, host) in READINGS[job].items():
        if any(n not in s for n in dev + host):
            out[name] = None
            continue
        out[name] = (sum(s[n]["device_ms"] for n in dev)
                     + sum(s[n]["host_ms"] for n in host)) / steps
    r = s.get("refresh", {})
    out["refresh_ms"] = r["device_ms"] / r["count"] if r.get("count") else None
    return out


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def spans_epoch(prog, traffic: dict) -> dict:
    """Step 2 of the module's description on ``prog``."""
    from customnerf_torch.engine import spans
    tr = prog.trainer
    spans.enable(True, tr.device)
    tr.train_one_epoch(prog.take(traffic["steps_per_dispatch"]))
    spans.reset()
    before = dict(spans.counters)
    n = traffic["epoch_steps"]
    _sync(tr.device)
    t0 = time.perf_counter()
    tr.train_one_epoch(prog.take(n))
    _sync(tr.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = spans.collect()
    spans.enable(False)
    s = got["spans"]
    step = next(k for k in STEP_SPANS if k in s)
    refresh = s.get("refresh", {"device_ms": 0.0, "count": 0})
    return {
        "steps": n, "epoch_wall_ms_per_step": wall_ms / n,
        "split": {k: {"ms": v["device_ms"] / n, "self_ms": v["self_ms"] / n,
                      "per_step": v["count"] / n, "host_ms": v["host_ms"] / n}
                  for k, v in sorted(s.items())},
        "step_span": step,
        "step_ms": s[step]["device_ms"] / s[step]["count"],
        "step_self_share": s[step]["self_ms"] / s[step]["device_ms"],
        "refresh_ms_per_step": refresh["device_ms"] / n,
        "stamps": got["stamps"],
        "counters": {k: v - before.get(k, 0) for k, v in got["counters"].items()
                     if k != "dropped_stamps"},
        "dropped_stamps": got["counters"]["dropped_stamps"],
        "got": got,
    }


def timed_window(prog, traffic: dict, seconds: float, on: bool) -> float:
    """ms a step of a window with the tracer ``on`` or off, after one
    dispatch outside it."""
    from benchmark.lib import training
    from customnerf_torch.engine import spans
    spans.enable(on, "cuda")
    prog.trainer.train_one_epoch(prog.take(traffic["steps_per_dispatch"]))
    w = training.window(prog, traffic, seconds)
    spans.enable(False)
    return 1e3 * w["wall_s"] / w["steps"]


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(merged, a, b) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in merged)


def read_profile(path: str, n_gaps: int = 10) -> dict:
    """What a ``--profile`` trace shows (step 4 of the module's
    description)."""
    from customnerf_torch.engine import spans
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    stamp = [e for e in dev if spans.STAMP_KERNEL in e.get("name", "")]
    work = _union((e["ts"], e["ts"] + e["dur"]) for e in dev if e not in stamp)
    track = [e for e in xs if e.get("cat") == "cn_span"]
    busy = {}
    for e in track:
        if e["dur"] > 0:
            busy.setdefault(e["name"], []).append(
                _covered(work, e["ts"], e["ts"] + e["dur"]) / e["dur"])
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                       "cuda_driver", "python_function")),
                  key=lambda h: h[0])
    gaps = []
    for (_, b), (c, _) in zip(work, work[1:]):
        gaps.append((c - b, b, c))
    gaps.sort(reverse=True)
    labelled = []
    for length, a, b in gaps[:n_gaps]:
        mid = (a + b) / 2
        over = [h for h in host if h[0] <= mid <= h[1]]
        inner = min(over, key=lambda h: h[1] - h[0])[2] if over else "host: no span"
        cn = [h for h in over if h[2].startswith(spans.PREFIX)]
        inner_cn = min(cn, key=lambda h: h[1] - h[0])[2] if cn else None
        labelled.append({"us": length, "innermost": inner[:80], "cn": inner_cn})
    starts = sorted(e["ts"] for e in stamp)

    def on_launch(x):
        k = bisect.bisect_left(starts, x - 1e-3)
        return k < len(starts) and starts[k] <= x + 1e-3
    ends = [x for e in track for x in (e["ts"], e["ts"] + e["dur"])]
    return {"stamp_kernels": len(stamp), "track_spans": len(track),
            "span_ends_on_a_launch": sum(map(on_launch, ends)) / max(len(ends), 1),
            "kernel_share_in_span": {k: statistics.median(v)
                                     for k, v in sorted(busy.items())},
            "idle_gaps": labelled,
            "cn_host_ranges": sorted({h[2] for h in host if h[2].startswith(spans.PREFIX)})}


def clock_pairs(path: str, clock_us: list) -> dict:
    """The trace's stamp-kernel starts less the stamps' card clock, paired
    in order where the trace holds as many launches as the ring stamps:
    how the two clocks sit (quartiles, the first and last ten)."""
    from customnerf_torch.engine import spans
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    starts = sorted(float(e["ts"]) for e in events if e.get("ph") == "X"
                    and spans.STAMP_KERNEL in e.get("name", ""))
    out = {"launches": len(starts), "stamps": len(clock_us)}
    if starts and len(starts) == len(clock_us):
        d = [a - b for a, b in zip(starts, clock_us)]
        q = statistics.quantiles(d, n=4)
        out.update(quartiles=q, first=d[:10], last=d[-10:],
                   gaps_us=[b - a for a, b in zip(clock_us[:10], clock_us[1:11])])
    return out


def profiled_epoch(prog, traffic: dict, steps: int) -> dict:
    """Step 4 of the module's description."""
    import os as _os

    from customnerf_torch.engine import spans
    tr = prog.trainer
    spans.enable(True, "cuda")
    tr.train_one_epoch(prog.take(traffic["steps_per_dispatch"]))
    tr.opt.profile = True
    prof = tr._start_profile()
    tr.train_one_epoch(prog.take(steps))
    tr._stop_profile(prof)
    spans.enable(False)
    path = _os.path.join(tr.opt.workspace, "profile", f"trace_ep{tr.epoch:04d}.json")
    out = read_profile(path)
    out["clocks"] = clock_pairs(path, [t * 1e-3 for _, t in spans._card_stamps()[0]])
    out["trace_mb"] = _os.path.getsize(path) / 1e6
    _os.remove(path)
    return out


def one_seed(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             cost_seconds: float, profile_steps: int = 0) -> dict:
    import torch

    from benchmark.lib import registry, training
    from benchmark.reference.train import initial_field
    from customnerf_torch.engine.measure import card_line

    job = registry.job(traffic["job"])
    t0 = time.perf_counter()
    prog = training.build(job, cfg, traffic, seed, training.workspace_dir(), "cuda")
    training.checked_steps(job, prog, traffic, initial_field(cfg, seed, "cuda"))
    job.finish_setup(prog, traffic)
    torch.cuda.synchronize()
    out = {"workload": cell["name"], "seed": seed, "card": card_line(),
           "setup_s": time.perf_counter() - t0}
    out["window_ms_per_step"] = timed_window(prog, traffic, seconds, on=False)
    ep = spans_epoch(prog, traffic)
    got = ep.pop("got")
    out.update(ep)
    out["readings"] = readings(traffic["job"], got, ep["steps"])
    step_plus = ep["step_ms"] + ep["refresh_ms_per_step"]
    out["step_plus_refresh_ms"] = step_plus
    out["step_plus_refresh_vs_window"] = step_plus / out["window_ms_per_step"] - 1.0
    if cost_seconds > 0:
        order = (False, True, True, False)
        ms = [timed_window(prog, traffic, cost_seconds, on) for on in order]
        off = statistics.mean(m for m, on in zip(ms, order) if not on)
        on_ = statistics.mean(m for m, on in zip(ms, order) if on)
        out["cost"] = {"order": ["off", "on", "on", "off"], "ms_per_step": ms,
                       "on_over_off": on_ / off - 1.0}
    if profile_steps > 0:
        out["profile"] = profiled_epoch(prog, traffic, profile_steps)
    training.free(prog)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost-seconds", type=float, default=0.0)
    p.add_argument("--profile-steps", type=int, default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    from benchmark.lib import registry
    from benchmark.run import cache_dirs
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"])
    cache_dirs(root)
    outs = []
    for seed in args.seeds:
        outs.append(one_seed(cell, cfg, traffic, seed, args.seconds, args.cost_seconds,
                             args.profile_steps))
        print(json.dumps(outs[-1]), flush=True)
    d = os.path.join("chiprun_out", "span_split")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{args.workload}.json"), "w") as f:
        json.dump(outs, f, indent=1)
    bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "customnerf_tpu"})
    if bad:
        print(f"[span_split] loaded: {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
