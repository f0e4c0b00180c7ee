"""Where a flagship reconstruction train step spends its time on the card.

    python -m customnerf_torch.engine.step_profile [--warmup 24] [--steps 10]

Runs the flagship recipe (``config.FLAGSHIP_ARGS``) on the synthetic
provider at 128×128 = 16,384 rays a step until the occupancy grid has left
its warm-up, then:

1. times ``--steps`` steps, each split into stages by CUDA events recorded
   around the port's own functions (AABB, march, compacted field evaluation
   with the tri-plane encode and the fused MLP inside it, composites, loss,
   Adam; the backward is the rest of the step);
2. traces 3 more steps with ``torch.profiler`` and reports the device-busy
   share of that window and the kernels that took the most device time;
3. times the tri-plane table gradient (dT) on the last traced step's own
   inputs, in the step (profiler) and replayed alone (CUDA events), with
   the share of samples whose cotangent is nonzero.

Prints one JSON line and writes it to ``chiprun_out/step_profile.json``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time

import torch

from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine.measure import captured_calls, card_line, device_ms
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.models import field as field_mod
from customnerf_torch.models import renderer
from customnerf_torch.ops import triplane
from customnerf_torch.ops.occupancy import WARMUP_UPDATES


class Spans:
    """CUDA-event spans summed by name; read after a synchronize."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.append((name, start, end))

    def collect(self):
        torch.cuda.synchronize()
        out = collections.defaultdict(float)
        for name, start, end in self.events:
            out[name] += start.elapsed_time(end)
        self.events.clear()
        return out


def _wrap(owner, attr, spans, name):
    fn = getattr(owner, attr)

    def timed(*args, **kwargs):
        with spans(name):
            return fn(*args, **kwargs)

    setattr(owner, attr, timed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=24)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA device")

    opt = parse_args(FLAGSHIP_ARGS + "--data_type synthetic --h 128 --w 128 "
                     "--seed 0 --update_extra_interval 4".split())
    trainer = Trainer(opt, log=lambda *_: None, use_checkpoint="scratch")
    loader = NeRFDataset(opt, "train", device=trainer.device).dataloader()

    def step():
        if trainer.global_step % opt.update_extra_interval == 0:
            trainer.update_extra_state()
        trainer.global_step += 1
        return trainer.train_step(loader.item(0))

    for _ in range(args.warmup):
        step()
    assert trainer.occ_state.iter_density > WARMUP_UPDATES, "grid still warming up"

    spans = Spans()
    _wrap(renderer, "near_far_from_aabb", spans, "aabb")
    _wrap(renderer, "march_rays_occupancy", spans, "march")
    _wrap(renderer, "_eval_field_compacted", spans, "compacted_eval")
    _wrap(renderer, "_composite", spans, "composite")
    _wrap(field_mod, "triplane_encode", spans, "triplane_encode_fwd")
    _wrap(field_mod, "fused_field_mlp", spans, "fused_mlp_fwd")
    _wrap(trainer, "render", spans, "render_fwd")
    _wrap(trainer, "loss", spans, "loss")
    _wrap(trainer.optimizer, "step", spans, "adam")

    per_step, refresh_ms, stats = [], [], None
    for _ in range(args.steps):
        if trainer.global_step % opt.update_extra_interval == 0:
            with spans("refresh"):
                trainer.update_extra_state()
            refresh_ms.append(spans.collect()["refresh"])
        trainer.global_step += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with spans("step"):
            _, _, stats = trainer.train_step(loader.item(0))
        ms = spans.collect()
        ms["wall"] = (time.perf_counter() - t0) * 1e3
        per_step.append(ms)
    mean = {k: sum(s.get(k, 0.0) for s in per_step) / len(per_step)
            for k in per_step[0]}
    mean["backward"] = mean["step"] - mean["render_fwd"] - mean["loss"] - mean["adam"]
    mean["compaction_bookkeeping"] = (mean["compacted_eval"]
                                      - mean["triplane_encode_fwd"]
                                      - mean["fused_mlp_fwd"])

    # profiler window: 3 steps, no refresh inside; the dT calls of its last
    # step are kept (references only: no work is added to the window)
    while trainer.global_step % opt.update_extra_interval != 1:
        step()
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured_calls(triplane, "plane_dtable", keep=6) as dt_calls, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    dtable = triplane.plane_dtable
    # kernels only (an op's row in key_averages repeats its kernels' time)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    dt_events = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += 1
            kernels[e.name][1] += e.time_range.elapsed_us() / 1e3
            if "plane_dtable_kernel" in e.name:
                dt_events.append((e.time_range.start, e.time_range.elapsed_us() / 1e3))
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:15]

    # dT on the last step's own inputs: in the step (profiler) and replayed
    # alone (CUDA events, host ahead) into a fresh [R·R, C] block and into
    # a block with the flat table gradient's row stride
    dtable_calls = []
    for (args, kwargs), (_, in_step) in zip(dt_calls, sorted(dt_events)[-6:]):
        u0, v0, fu, fv, g, R, C = args[:7]
        ld, bf16 = kwargs["out"].stride(0), kwargs.get("bf16", False)
        wide = torch.zeros(R * R, ld, device=g.device)
        dtable_calls.append({
            "R": R, "C": C, "bf16": bf16,
            "live_share": float((g != 0).any(dim=1).float().mean()),
            "in_step_ms": in_step,
            "replay_fresh_ms": device_ms(
                lambda: dtable(u0, v0, fu, fv, g, R, C, bf16=bf16), 20),
            "replay_table_ld_ms": device_ms(
                lambda: dtable(u0, v0, fu, fv, g, R, C, out=wide, bf16=bf16), 20),
        })

    result = {
        "card": card_line(),
        "torch": torch.__version__,
        "rays_per_step": opt.h * opt.w,
        "stage_ms_per_step": mean,
        "refresh_ms": refresh_ms,
        "slab_fill": float(stats["slab_fill"]),
        "overflow_frac": float(stats["overflow_frac"]),
        "profile_window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / window_ms,
        "dtable_calls": dtable_calls,
        "top_kernels": [{"name": name[:90], "launches_per_step": n / 3,
                         "device_ms_per_step": ms / 3,
                         "device_ms_per_launch": ms / n}
                        for name, (n, ms) in top],
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "step_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
