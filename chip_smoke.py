#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``customnerf_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) if anything is wrong:

1. setup: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the kernels built from ``customnerf_torch/csrc`` (seconds).
2. trainer (the main path): the flagship reconstruction recipe
   (``config.FLAGSHIP_ARGS``, ``scripts/bear.sh:18-20``) on the synthetic
   provider at 128×128 = 16,384 rays a step, through the port's ``Trainer``,
   with the occupancy grid refreshed every 4 steps so that it leaves its
   warm-up.  The launch counters are zeroed just before and read just after;
   both kernels must have run, and the refresh must have taken the
   density-only head.  The loss on a fixed view must be finite and lower
   after the steps than before; one validation view is rendered through
   ``render_image`` and its PSNR printed.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the inputs the main path gave it — the fused field MLP on one train
   step's 229,376 compacted samples and, density-only, on one refresh's
   4,194,304 queries (whose sigma must equal the full head's bit for bit),
   the tri-plane table gradient on the XY plane of each level
   ((R, C) = (128, 16) and (512, 8)) of the last train step — with
   CUDA-event device times (``engine/measure.py``) of the kernel, the plain
   version and, where one exists, a single library call.  These launches
   come after the counters were read.
4. the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.  Exits nonzero, with
no result, when no CUDA device is available.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): TF32 on the tensor
# cores, f32 outside them, and HBM3 bandwidth.  bound_ms = max(operations /
# the peak of the unit that runs them, bytes / HBM).
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3               # K1 runs each f32 product as three TF32 products

SMOKE_FLAGS = ("--backend pallas --data_type synthetic --h 128 --w 128 "
               "--seed 0 --update_extra_interval 4").split()
TRAIN_STEPS = 40
STEP_RAYS = 128 * 128
STEP_SAMPLES = 229_376        # 256 blocks × 896 slots
REFRESH_QUERIES = 2 * 128 ** 3


def log(msg):
    print(msg, flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------- trainer
def run_trainer():
    """The main path.  Returns its summary and the kernels' inputs as the
    main path gave them."""
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer, psnr
    from customnerf_torch.models import field
    from customnerf_torch.ops import fused_mlp, triplane, triplane_kernels
    from customnerf_torch.ops.occupancy import WARMUP_UPDATES

    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS)
    trainer = Trainer(opt)
    dev = trainer.device
    train = NeRFDataset(opt, "train", device=dev).dataloader()
    val = NeRFDataset(opt, "val", device=dev).dataloader()
    fixed = train.item(0)
    assert fixed.rays_o.shape[0] == STEP_RAYS, fixed.rays_o.shape

    @torch.no_grad()
    def fixed_loss():
        out = trainer.render(fixed.rays_o, fixed.rays_d, train=True, perturb=False)
        loss, _ = trainer.loss(out, fixed.rgbs.reshape(-1, 3), fixed.mask.reshape(-1))
        return float(loss)

    with captured_calls(field, "fused_field_mlp", keep=4) as mlp_calls, \
            captured_calls(triplane, "plane_dtable", keep=6) as dt_calls:
        # the main path starts here: counters read only launches of this run
        fused_mlp.fused_mlp_forward.launches = 0
        triplane_kernels.plane_dtable.launches = 0
        t_start = time.time()
        loss_before = fixed_loss()
        steps, refresh_ms, mlp_inputs = [], [], {}
        for _ in range(TRAIN_STEPS):
            batch = train.item(0)
            if trainer.global_step % opt.update_extra_interval == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.update_extra_state()
                torch.cuda.synchronize()
                refresh_ms.append((time.perf_counter() - t0) * 1e3)
                mlp_inputs[REFRESH_QUERIES] = mlp_calls[-1]
            trainer.global_step += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, aux, stats = trainer.train_step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            mlp_inputs[STEP_SAMPLES] = mlp_calls[-1]
            steps.append({"step": trainer.global_step, "ms": ms, "loss": float(loss),
                          "warm": trainer.occ_state.iter_density > WARMUP_UPDATES,
                          "slab_fill": float(stats["slab_fill"]),
                          "overflow_frac": float(stats["overflow_frac"]),
                          "budget": stats["budget"]})
        loss_after = fixed_loss()
        view = val.item(0)
        out = trainer.render_image(view.rays_o, view.rays_d)
        torch.cuda.synchronize()
        wall_s = time.time() - t_start
        launches = {"fused_field_mlp": fused_mlp.fused_mlp_forward.launches,
                    "plane_dtable": triplane_kernels.plane_dtable.launches}

    img = out["image"]
    assert img.shape == (view.H * view.W, 3), img.shape
    assert bool(torch.isfinite(img).all()), "non-finite render"
    view_psnr = psnr(img, view.rgbs.reshape(-1, 3))
    losses = [s["loss"] for s in steps]
    assert all(math.isfinite(v) for v in losses + [loss_before, loss_after]), losses
    assert loss_after < loss_before, (loss_before, loss_after)
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"
    steady = [s for s in steps if s["warm"]]
    assert steady, "the occupancy grid never left its warm-up"
    assert statistics.mean(s["overflow_frac"] for s in steady) < 1.0, \
        "every block overflowed: the compacted path never ran exactly"
    for n, (args, _) in mlp_inputs.items():
        assert args[0].shape[0] == n, (n, args[0].shape)
    assert mlp_inputs[REFRESH_QUERIES][1] == {"with_rgb": False}, \
        "the refresh did not take the density-only head"
    summary = {
        "steps": steps, "refresh_ms": refresh_ms, "launches": launches,
        "loss_before": loss_before, "loss_after": loss_after,
        "psnr_val0": view_psnr, "wall_s": wall_s,
        "steady_ms_per_step": statistics.median(s["ms"] for s in steady),
        "steady_slab_fill": statistics.mean(s["slab_fill"] for s in steady),
        "steady_overflow_frac": statistics.mean(s["overflow_frac"] for s in steady),
        "budget": steady[-1]["budget"],
    }
    return summary, mlp_inputs, list(dt_calls)


# ----------------------------------------------------------------- kernels
def check_fused_mlp(x, v, ws, with_rgb=True):
    """K1 against reference_forward (f32 cuBLAS, TF32 off) on the inputs the
    main path gave it."""
    import torch
    from customnerf_torch.engine.measure import device_ms
    from customnerf_torch.ops import fused_mlp as fm

    B, in_dim = x.shape
    dir_dim, hid, n_out = ws[5].shape[0] - ws[1].shape[0], ws[0].shape[1], ws[6].shape[1]
    sig_k, rgb_k = fm.fused_mlp_forward(x, v, ws, with_rgb)
    sig_p, rgb_p = fm.reference_forward(x, v, ws, with_rgb)
    torch.cuda.synchronize()
    outs = [(sig_k, sig_p)] + ([(rgb_k, rgb_p)] if with_rgb else [])
    err = max(float((k - p).abs().max()) for k, p in outs)
    scale = max(float(p.abs().max()) for _, p in outs)
    # split-TF32 (three TF32 products, each operand's dropped part ≤ 2^-22
    # of it) against f32 with another summation order over ≤ 91-term dots
    # in 3-5 layers: well under 1e-4 of the largest output; a wrong index or
    # a missed tile gives errors of order one
    tol = 1e-4 * max(scale, 1.0)
    if not (err <= tol and all(bool(torch.isfinite(k).all()) for k, _ in outs)):
        raise AssertionError(f"fused_mlp B={B}: max_abs_err {err} > tol {tol}")
    sigma_bitwise = None
    if not with_rgb:
        # sigma of the density-only head is the full head's, bit for bit
        zeros = torch.zeros(B, dir_dim, device=x.device)
        sigma_bitwise = bool(torch.equal(fm.fused_mlp_forward(x, zeros, ws)[0], sig_k))
        if not sigma_bitwise:
            raise AssertionError("density-only sigma differs from the full call's")
    reps = 20 if B < 10 ** 6 else 5
    k_ms = device_ms(lambda: fm.fused_mlp_forward(x, v, ws, with_rgb), reps)
    call_ms = device_ms(lambda: fm.fused_mlp_forward(x, v, ws, with_rgb), reps,
                        host_ahead=False)
    p_ms = device_ms(lambda: fm.reference_forward(x, v, ws, with_rgb), reps)
    used = ws if with_rgb else ws[:5]
    macs = sum(w.shape[0] * w.shape[1] for w in used)
    nbytes = (B * (in_dim + 1 + (dir_dim + n_out if with_rgb else 0)) * 4
              + macs * 4)
    b_ms, b_by = bound(TF32_PASSES * 2.0 * macs * B, nbytes, PEAK_TF32_FLOPS)
    f32_ms, _ = bound(2.0 * macs * B, nbytes)
    return {"name": "fused_field_mlp",
            "shape": f"B={B} in={in_dim} dir={dir_dim} hidden={hid} out={n_out}"
                     + ("" if with_rgb else " density-only"),
            "route": "cuda", "source": "customnerf_torch/csrc/fused_mlp.cu",
            "replaces": "customnerf_tpu/ops/fused_mlp_pallas.py:59",
            "max_abs_err": err, "tolerance": tol, "ms": k_ms, "kernel_ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_peak": "3 passes at the dense TF32 tensor rate 495 TFLOP/s; "
                          "HBM3 3.35 TB/s",
            "bound_f32_fma_ms": f32_ms, "library_ms": None,
            "sigma_bitwise": sigma_bitwise}


def check_dtable(u0, v0, fu, fv, g, R: int, C: int):
    """dT kernel against its plain version (index_add_) and a single
    index_add_ call (the library yardstick), on one plane of a train step."""
    import torch
    from customnerf_torch.engine.measure import device_ms
    from customnerf_torch.ops import triplane_kernels as tk

    B = u0.shape[0]
    got = tk.plane_dtable(u0, v0, fu, fv, g, R, C)
    want = tk.plane_dtable_reference(u0, v0, fu, fv, g, R, C)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # both sum in an order set by atomics; a texel takes up to a few
    # thousand terms: a few ulp of the largest texel sum
    tol = 1e-5 * max(float(want.abs().max()), 1e-6)
    if not err <= tol:
        raise AssertionError(f"plane_dtable R={R} C={C}: max_abs_err {err} > tol {tol}")
    # into a zeroed block, as the main path calls it (the step zero-fills
    # the whole table gradient once)
    into = torch.zeros(R * R, C, device=g.device)
    k_ms = device_ms(lambda: tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=into), 20)
    call_ms = device_ms(lambda: tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=into),
                        20, host_ahead=False)
    p_ms = device_ms(lambda: tk.plane_dtable_reference(u0, v0, fu, fv, g, R, C,
                                                       out=into), 20)
    rows, w = tk.corner_rows_weights(u0, v0, fu, fv, R)
    rows = rows.reshape(-1)
    vals = (w[:, :, None] * g[:, None, :]).reshape(-1, C)
    out = torch.zeros(R * R, C, device=g.device)
    lib_ms = device_ms(lambda: out.index_add_(0, rows, vals), 20)
    # samples whose cotangent is all zero (dead compaction slots) add
    # nothing: time the kernel on the others alone
    live = (g != 0).any(dim=1)
    n_live = int(live.sum())
    sel = [t[live].contiguous() for t in (u0, v0, fu, fv, g)]
    live_ms = device_ms(lambda: tk.plane_dtable(*sel, R, C, out=into), 20)
    # every g is read (to find the zeros); corners and fractions of the live
    # samples; the plane written once
    nbytes = B * 4 * C + n_live * 16 + R * R * C * 4
    b_ms, b_by = bound(8.0 * C * n_live, nbytes)
    return {"name": "plane_dtable", "shape": f"R={R} C={C} B={B}",
            "route": "cuda", "source": "customnerf_torch/csrc/triplane_dtable.cu",
            "replaces": "customnerf_tpu/ops/triplane_pallas.py:57, "
                        "customnerf_tpu/ops/triplane_pallas.py:166",
            "max_abs_err": err, "tolerance": tol, "ms": k_ms, "kernel_ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_peak": "HBM3 3.35 TB/s; f32 67 TFLOP/s",
            "library_ms": lib_ms, "live_share": n_live / B,
            "live_rows_ms": live_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from customnerf_torch.engine.measure import card_line
    from customnerf_torch.ops import kernels

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    so = kernels.build()
    kernels.library()
    build_s = time.time() - t0
    log(f"kernels built in {build_s:.1f} s -> {os.path.relpath(so)}")

    tr, mlp_inputs, dt_calls = run_trainer()
    ms = tr["steady_ms_per_step"]
    log(f"[trainer] {card} | {TRAIN_STEPS} steps of {STEP_RAYS} rays | steady "
        f"{ms:.2f} ms/step = {STEP_RAYS / ms * 1e3:.0f} rays/s | slab fill "
        f"{tr['steady_slab_fill']:.3f} | overflowing blocks "
        f"{tr['steady_overflow_frac']:.3f} | budget {tr['budget']} slots/block | "
        f"refresh {statistics.median(tr['refresh_ms']):.1f} ms")
    log(f"[trainer] fixed-view loss {tr['loss_before']:.5f} -> {tr['loss_after']:.5f} "
        f"| launches {tr['launches']} | val view PSNR {tr['psnr_val0']:.2f} dB")

    # dT calls of the last step: (level 0: XY, XZ, YZ), (level 1: ...)
    rows = [check_fused_mlp(*args, **kw) for args, kw in
            (mlp_inputs[STEP_SAMPLES], mlp_inputs[REFRESH_QUERIES])]
    rows += [check_dtable(*dt_calls[i][0][:7]) for i in (0, 3)]
    for r in rows:
        r["launches"] = tr["launches"][r["name"]]
        log(f"[kernel] {r['name']} {r['shape']}: err {r['max_abs_err']:.3g} "
            f"(tol {r['tolerance']:.3g}) kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms (a wrapper call with the host in the loop "
            f"{r['call_ms']:.4f} ms) bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f" library {r['library_ms']:.4f} ms" if r["library_ms"] else "")
            + (f" | live rows {r['live_share']:.3f}: {r['live_rows_ms']:.4f} ms"
               if "live_rows_ms" in r else
               f" | f32-FMA bound {r['bound_f32_fma_ms']:.4f} ms"))

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "ptxas": kernels.ptxas_log, "kernels": rows, "trainer": tr},
                  f, indent=1)

    keys = ("name", "shape", "route", "source", "replaces", "launches",
            "max_abs_err", "tolerance", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_peak", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
