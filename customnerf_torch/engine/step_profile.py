"""Where a flagship reconstruction train step spends its time on the card.

    python -m customnerf_torch.engine.step_profile [--warmup 24] [--steps 96]

Runs the flagship recipe (``config.FLAGSHIP_ARGS``) on the synthetic
provider at 128×128 = 16,384 rays a step until the occupancy grid has left
its warm-up, then:

1. the tracer's graphed split (``engine/spans.py``): one epoch of
   ``--steps`` steps through ``Trainer.train_one_epoch``, K = 8 replays of
   one captured step a dispatch and a refresh every ``--update_extra_interval``
   steps (captured with the tracer on before the epoch).  Each device span
   in ms a step, total and self (less its children); ``recon.step`` ›
   ``render`` (› ``march``, ``eval``, ``composite``), ``loss``,
   ``backward`` (› ``k1.bwd``), ``adam``; the refresh in ms a refresh; the
   host spans (pre-pass, replay copies and launch, loss fetch) in ms a
   step; the wall of the epoch over its steps beside them;
2. traces 3 eager steps with ``torch.profiler`` and lists the kernels that
   took the most device time;
3. times the tri-plane table gradient (dT) on the last traced step's own
   inputs, in the step (profiler) and replayed alone (CUDA events), with
   the share of samples whose cotangent is nonzero.

``--hw H W`` sets the frame (rays a step): ``--hw 57 42`` is the 2,394-ray
step of the repo's fixtures at ``--train_resolution_level 7``.

Prints one JSON line and writes it to ``chiprun_out/step_profile.json``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import torch

from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine import spans
from customnerf_torch.engine.measure import captured_calls, card_line, device_ms
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.ops import triplane
from customnerf_torch.ops.occupancy import WARMUP_UPDATES


def graphed_split(trainer, batches) -> dict:
    """The tracer's split of one epoch over ``batches`` through
    ``train_one_epoch``: the step captured with the tracer on first (one
    dispatch, outside the epoch), then the epoch.  Returns each span's ms a
    step (``refresh`` in ms a refresh), the epoch's wall a step and the
    counters of the epoch."""
    was_on = spans.enabled()
    spans.enable(True, trainer.device)
    trainer.train_one_epoch(batches[:trainer.steps_per_dispatch()])
    spans.reset()
    before = dict(spans.counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_one_epoch(batches)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = spans.collect()
    spans.enable(was_on, trainer.device)
    n = len(batches)
    split = {}
    for name, s in got["spans"].items():
        per = s["count"] if name == "refresh" else n
        per = max(per, 1)
        split[name] = {"ms": s["device_ms"] / per, "self_ms": s["self_ms"] / per,
                       "host_ms": s["host_ms"] / per, "count": s["count"]}
    return {"steps": n, "wall_ms_per_step": wall_ms / n, "spans": split,
            "counters": {k: v - before.get(k, 0) for k, v in got["counters"].items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=24)
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--update_extra_interval", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 128),
                    help="frame height and width: rays a step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA device")

    opt = parse_args(FLAGSHIP_ARGS + "--data_type synthetic --seed 0 ".split()
                     + ["--update_extra_interval", str(args.update_extra_interval),
                        "--h", str(args.hw[0]), "--w", str(args.hw[1])])
    trainer = Trainer(opt, log=lambda *_: None, use_checkpoint="scratch")
    loader = NeRFDataset(opt, "train", device=trainer.device).dataloader()

    def step():
        if trainer.global_step % opt.update_extra_interval == 0:
            trainer.update_extra_state()
        trainer.global_step += 1
        return trainer.train_step(loader.item(0))

    while (trainer.occ_state.iter_density <= WARMUP_UPDATES
           or trainer.global_step < args.warmup):
        step()
    batches = [loader.item(i % len(loader)) for i in range(args.steps)]
    split = graphed_split(trainer, batches)

    # profiler window: 3 eager steps; the dT calls of its last step are kept
    # (references only: no work is added to the window)
    from torch.profiler import ProfilerActivity, profile
    with captured_calls(triplane, "plane_dtable", keep=6) as dt_calls, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _, _, stats = step()
        torch.cuda.synchronize()
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
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:15]

    # dT on the last step's own inputs: in the step (profiler) and replayed
    # alone (CUDA events, host ahead) into a fresh [R·R, C] block and into
    # a block with the flat table gradient's row stride
    dtable_calls = []
    for (a, kwargs), (_, in_step) in zip(dt_calls, sorted(dt_events)[-6:]):
        u0, v0, fu, fv, g, R, C = a[:7]
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
        "graphed_split": split,
        "slab_fill": float(stats["slab_fill"]),
        "overflow_frac": float(stats["overflow_frac"]),
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
