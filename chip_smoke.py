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
4. checkpoint: the trainer of phase 2 saves its checkpoint into
   ``chiprun_out/``; an editing trainer (``scripts/bear.sh``'s phase-2
   flags, ``--editing_from`` that file) is built from it, and its frozen
   field must render the validation view bit for bit as the saving trainer
   does (``perturb=False``, the restored occupancy grid equal to the saved).
5. full width: the SD 1.5 stack (UNet, VAE, CLIP ViT-L/14 text, CLIP
   ViT-B/32 matcher) is built on the card from a seeded generator, in
   float32, and its parameter counts must equal the JAX package's
   (``guidance/sds.py::FULL_WIDTH_PARAMS``, pinned by a CPU test).
6. editing (the second path): 8 LGIE/SDS steps on the same 128×128 frames
   (16,384 rays a step).  Counters zeroed just before and read just after;
   both kernels must have launched, both LGIE branches and the clip_view
   prompt selection must have run, every loss must be finite and the field
   must have changed.  Prints the step's median ms and its split (render to
   latents, UNet, backward + Adam), its peak memory, the SD stack's init
   seconds and the frozen pt render's ms.
7. kernels on the editing inputs: K1 on the last editing step's render and
   dT at (128, 16) and (512, 8) on its backward, against their plain
   versions, with the live-sample share.
8. the ``{"kernels": [...]}`` line (reconstruction and editing rows), then
   the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.  Exits nonzero, with
no result, when no CUDA device is available.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
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
               "--seed 0 --update_extra_interval 4 --use_ckpt scratch "
               "--ckpt scratch").split()
RECON_WORKSPACE = os.path.join("chiprun_out", "smoke_recon")
# scripts/bear.sh:39-48, phase 2, on the synthetic provider with random SD
# weights; --iters 8 puts the last half of the steps under --stage_time
EDIT_FLAGS = ["--pretrained", "--text", "a corgi in a forest", "--text_fg",
              "a corgi", "--lambda_sd", "0.01", "--keep_bg", "1000", "--cfg",
              "100", "--random_bg_c", "--detach_bg", "--clip_view",
              "--stage_time", "--sd_version", "1.5", "--allow_random_guidance",
              "--iters", "8", "--workspace",
              os.path.join("chiprun_out", "smoke_edit")]
EDIT_STEPS = 8
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

    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + ["--workspace", RECON_WORKSPACE])
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


# ----------------------------------------------------------------- editing
def _equal_renders(a, b) -> bool:
    import torch
    return all(torch.equal(a[k], b[k]) for k in ("image", "depth", "weights_sum",
                                                  "render_mask")) and \
        all(torch.equal(a[s][k], b[s][k]) for s in ("fg", "bg") for k in a[s])


def run_checkpoint(recon):
    """Phase 4: save, build the editing trainer from the file, and render
    the validation view through the frozen field bit for bit as the saving
    trainer.  Returns (editing trainer, its options, summary)."""
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.sds import StableDiffusionGuidance

    path = recon.save_checkpoint()
    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + EDIT_FLAGS
                     + ["--editing_from", path])
    guidance = StableDiffusionGuidance(opt)
    trainer = Trainer(opt, guidance=guidance, use_checkpoint=opt.ckpt)
    occ_a, occ_b = recon.occ_state, trainer.occ_state
    assert torch.equal(occ_a.bitfield, occ_b.bitfield) and \
        torch.equal(occ_a.density_grid, occ_b.density_grid) and \
        occ_a.iter_density == occ_b.iter_density, "occupancy grid not restored"
    view = NeRFDataset(opt, "val", device=trainer.device).dataloader().item(0)
    saved = recon.render_image(view.rays_o, view.rays_d, perturb=False)
    loaded = trainer.render_image(view.rays_o, view.rays_d, perturb=False,
                                  field=trainer.field_pretrained)
    assert _equal_renders(saved, loaded), "the reloaded field renders differently"
    return trainer, opt, {"checkpoint": os.path.relpath(path),
                          "bytes": os.path.getsize(path), "bitwise": True}


def sd_bounds(guidance):
    """The least time the card could take for the SD parts of an editing
    step, from FLOPs counted by ``torch.utils.flop_counter`` on the meta
    device (matmuls and convolutions; elementwise work is not counted) at
    the f32 peak, and the bytes of each part's weights and inputs/outputs at
    the HBM peak: the UNet's forward on [2, 4, 64, 64], and the VAE
    encoder's forward and its backward to the image at 512²."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from customnerf_torch.guidance.layers import build, n_params
    from customnerf_torch.guidance.unet import UNet2DCondition
    from customnerf_torch.guidance.vae import AutoencoderKL

    meta = torch.device("meta")
    unet = build(UNet2DCondition, guidance.unet.cfg, device=meta).requires_grad_(False)
    vae = build(AutoencoderKL, guidance.vae.cfg, device=meta).requires_grad_(False)
    lat = torch.empty(2, 4, 64, 64, device=meta)
    with FlopCounterMode(display=False) as fc:
        unet(lat, torch.zeros(2, dtype=torch.long, device=meta),
             torch.empty(2, 77, 768, device=meta))
    unet_flops = fc.get_total_flops()
    img = torch.empty(1, 3, 512, 512, device=meta, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        z = vae.encode(img, noise=torch.empty(1, 4, 64, 64, device=meta))
    enc_flops = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        z.sum().backward()
    bwd_flops = fc.get_total_flops()
    enc_bytes = 4 * (n_params(vae.encoder) + n_params(vae.quant_conv)
                     + img.numel() + 2 * z.numel())
    unet_bytes = 4 * (n_params(unet) + 2 * 2 * lat.numel() + 2 * 77 * 768)
    out = {}
    for name, flops, nbytes in (("unet_forward", unet_flops, unet_bytes),
                                ("vae_encoder_forward", enc_flops, enc_bytes),
                                ("vae_encoder_backward", bwd_flops, 2 * enc_bytes)):
        ms, by = bound(flops, nbytes)
        out[name] = {"flops": flops, "bytes": nbytes, "bound_ms": ms, "bound_by": by}
    return out


def profile_editing_step(trainer, batch, n_top: int = 12):
    """One more editing step under ``torch.profiler``: device time by
    kernel name (kernels only), the busy share of the step's window."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.global_step += 1
        trainer.train_step(batch)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += 1
            kernels[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:n_top]
    return {"window_ms": window_ms, "kernel_ms": busy,
            "busy_share": busy / window_ms if window_ms else None,
            "n_kernels": sum(n for n, _ in kernels.values()),
            "top": [{"name": k[:120], "launches": n, "ms": ms} for k, (n, ms) in top]}


def run_editing(trainer, opt):
    """Phases 5-6: the full-width SD stack, then EDIT_STEPS editing steps
    through ``Trainer.train_step``.  Returns its summary and the kernels'
    inputs of the last step."""
    import torch
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.guidance.layers import n_params
    from customnerf_torch.guidance.sds import FULL_WIDTH_PARAMS
    from customnerf_torch.models import field
    from customnerf_torch.ops import fused_mlp, triplane, triplane_kernels

    guidance = trainer.guidance
    editing.prepare_text_embeddings(trainer)
    counts = dict(guidance.param_counts(),
                  clip_view=n_params(trainer.clip_matcher.model))
    assert counts == FULL_WIDTH_PARAMS, (counts, FULL_WIDTH_PARAMS)
    models = (guidance.unet, guidance.vae, guidance.text_encoder.model,
              trainer.clip_matcher.model)
    assert all(p.dtype == torch.float32 and p.is_cuda
               for m in models for p in m.parameters()), "SD stack not f32 on the card"

    dev = trainer.device
    train = NeRFDataset(opt, "train", device=dev).dataloader()
    before = [p.detach().clone() for p in trainer.field.parameters()]
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    with captured_calls(field, "fused_field_mlp", keep=4) as mlp_calls, \
            captured_calls(triplane, "plane_dtable", keep=6) as dt_calls:
        # the editing path starts here: counters read only its launches
        fused_mlp.fused_mlp_forward.launches = 0
        triplane_kernels.plane_dtable.launches = 0
        for _ in range(EDIT_STEPS):
            batch = train.item(0)
            refreshed = trainer.global_step % opt.update_extra_interval == 0
            if refreshed:
                trainer.update_extra_state()
            trainer.global_step += 1
            events = {}

            def mark(name):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()

            mark("start")
            loss, aux, stats = trainer.train_step(batch, mark=mark)
            torch.cuda.synchronize()
            span = {k: events[a].elapsed_time(events[b]) for k, a, b in (
                ("total", "start", "update"), ("pt_and_draws", "start", "pt"),
                ("render_to_latents", "pt", "latents"), ("unet", "latents", "unet"),
                ("backward_adam", "unet", "update"))}
            mlp_input = mlp_calls[-1]
            steps.append(dict(span, step=trainer.global_step, refreshed=refreshed,
                              loss=float(loss), loss_sds=float(aux["loss_sds"]),
                              loss_bg=float(aux["loss_bg"]),
                              local=bool(stats["local"]), t=int(stats["t"]),
                              pt_cached=len(trainer.pt_dict)))
        launches = {"fused_field_mlp": fused_mlp.fused_mlp_forward.launches,
                    "plane_dtable": triplane_kernels.plane_dtable.launches}
    peak = torch.cuda.max_memory_allocated()

    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the editing path"
    assert all(math.isfinite(s[k]) for s in steps
               for k in ("loss", "loss_sds", "loss_bg")), steps
    assert {s["local"] for s in steps} == {True, False}, "an LGIE branch never ran"
    assert all(e["match_probs"] is not None for e in trainer.pt_dict.values()), \
        "clip_view prompt selection did not run"
    moved = [float((p.detach() - b).abs().max())
             for p, b in zip(trainer.field.parameters(), before)]
    assert all(m > 0 for m in moved), f"the field did not change: {moved}"
    assert mlp_input[0][0].shape[0] == STEP_SAMPLES, mlp_input[0][0].shape

    view = train.item(0)
    t_pt = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        trainer.render_image(view.rays_o, view.rays_d, perturb=True,
                             field=trainer.field_pretrained)
        b.record()
        torch.cuda.synchronize()
        t_pt.append(a.elapsed_time(b))
    cached = [s for s in steps if s["pt_and_draws"] < 0.5 * statistics.median(t_pt)]
    summary = {
        "steps": steps, "launches": launches, "param_counts": counts,
        "sd_init_s": guidance.init_seconds,
        "peak_gb": peak / 1e9, "resident_before_steps_gb": base_mem / 1e9,
        "pt_render_ms": statistics.median(t_pt),
        "median_ms": {k: statistics.median(s[k] for s in steps) for k in (
            "total", "pt_and_draws", "render_to_latents", "unet", "backward_adam")},
        "median_ms_pt_cached": (statistics.median(s["total"] for s in cached)
                                if cached else None),
        "field_max_change": max(moved),
        "local_steps": sum(s["local"] for s in steps),
        "sd_bounds": sd_bounds(guidance),
        "profile": profile_editing_step(trainer, view),
    }
    return summary, mlp_input, list(dt_calls)


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

    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer
    with captured_calls(Trainer, "train_step", keep=1) as last_step:
        tr, mlp_inputs, dt_calls = run_trainer()
    recon = last_step[-1][0][0]
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
        r["path"] = "reconstruction"

    editor, edit_opt, ck = run_checkpoint(recon)
    log(f"[checkpoint] saved {ck['checkpoint']} ({ck['bytes']} bytes); the "
        f"editing trainer's frozen field renders the validation view bit for "
        f"bit; occupancy grid restored")
    del recon
    ed, edit_mlp, edit_dt = run_editing(editor, edit_opt)
    med = ed["median_ms"]
    log(f"[full width] SD 1.5 stack in float32, parameters {ed['param_counts']}, "
        f"built on the card in {ed['sd_init_s']:.2f} s")
    log(f"[editing] {card} | {EDIT_STEPS} steps of {STEP_RAYS} rays | median "
        f"{med['total']:.1f} ms/step ({ed['median_ms_pt_cached']} ms with the pt "
        f"render cached): pt + draws {med['pt_and_draws']:.1f}, render to "
        f"latents {med['render_to_latents']:.1f}, UNet {med['unet']:.1f}, "
        f"backward + Adam {med['backward_adam']:.1f} | peak "
        f"{ed['peak_gb']:.2f} GB | frozen pt render {ed['pt_render_ms']:.1f} ms "
        f"| local steps {ed['local_steps']}/{EDIT_STEPS} | launches {ed['launches']}")
    for name, b in ed["sd_bounds"].items():
        log(f"[editing bound] {name}: {b['flops'] / 1e12:.3f} TFLOP, "
            f"{b['bytes'] / 1e9:.3f} GB -> {b['bound_ms']:.2f} ms ({b['bound_by']}; "
            f"f32 67 TFLOP/s, HBM3 3.35 TB/s)")
    prof = ed["profile"]
    log(f"[editing profile] one step: {prof['kernel_ms']:.1f} ms of kernels in a "
        f"{prof['window_ms']:.1f} ms window ({prof['n_kernels']} launches); top: "
        + "; ".join(f"{t['name'][:60]} {t['ms']:.1f} ms x{t['launches']}"
                    for t in prof["top"][:5]))
    edit_rows = [check_fused_mlp(*edit_mlp[0], **edit_mlp[1])]
    edit_rows += [check_dtable(*edit_dt[i][0][:7]) for i in (0, 3)]
    for r in edit_rows:
        r["launches"] = ed["launches"][r["name"]]
        r["path"] = "editing"
    rows += edit_rows
    for r in rows:
        log(f"[kernel] {r['path']} {r['name']} {r['shape']}: err {r['max_abs_err']:.3g} "
            f"(tol {r['tolerance']:.3g}) kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms (a wrapper call with the host in the loop "
            f"{r['call_ms']:.4f} ms) bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f" library {r['library_ms']:.4f} ms" if r["library_ms"] else "")
            + (f" | live rows {r['live_share']:.3f}: {r['live_rows_ms']:.4f} ms"
               if "live_rows_ms" in r else
               f" | f32-FMA bound {r['bound_f32_fma_ms']:.4f} ms"))

    # the checkpoint (~180 MB with its Adam state) has served its purpose
    shutil.rmtree(RECON_WORKSPACE, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "ptxas": kernels.ptxas_log, "kernels": rows, "trainer": tr,
                   "checkpoint": ck, "editing": ed},
                  f, indent=1)

    keys = ("name", "path", "shape", "route", "source", "replaces", "launches",
            "max_abs_err", "tolerance", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_peak", "library_ms", "live_share")
    log(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
