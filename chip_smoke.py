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
   density-only head.  Every loss must be finite and every parameter must
   have moved; the loss on a fixed view is printed before and after (on
   this scene it does not fall within 40 steps from the flax init: the
   quality phase checks learning, with PSNR gates); one validation view is
   rendered through ``render_image`` and its PSNR printed.
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
8. parity: ``scripts/bear.sh --parity``'s field on the
   synthetic provider — ``-O2``, the reference tiled grid (16 levels × 2
   channels at 2^21 rows, desired resolution 8192: a 23,967,296 × 2
   table), 64 + 64 samples, 16,384 rays a step, 20 steps through
   ``Trainer.train_step`` with CUDA-event stage times (coarse encode + K1
   density-only, ``sample_pdf`` + sort, fine encode + K1, composites,
   loss, backward, Adam), the median step, rays/s and peak memory.
   Counters zeroed before and read after; K1 must launch.  Every loss
   finite, every parameter moved.  K1 is held against its plain version on
   the last step's 2,097,152 fine and 1,048,576 coarse (density-only)
   samples; the grid encode's forward and backward are timed on the fine
   points, and ``grid_encode`` on the card is held against the same call
   on the CPU (tiled and hash, 65,536 points).  The field is exported as a
   reference-format (tcnn) checkpoint and loaded through
   ``Trainer(use_checkpoint=...)``: it must render bit for bit.  Then
   ``bear.sh --parity`` phase 2: 4 editing steps on ``-O2`` from the parity
   reconstruction's checkpoint, with the SD stack of phase 5 (stage
   times, peak memory); K1 must launch.
9. quality (the third path): ``scripts/bear.sh`` phase 1's flags (3000
   steps, an evaluation each epoch, then the test path) through
   ``customnerf_torch.__main__.main`` on the repo's bear (nerfstudio, 28
   views), LLFF and DTU (24 views each) fixtures at 400×300, and
   ``bear.sh --parity`` phase 1 on the bear.  The fixtures are written by
   ``python -m customnerf_torch.data.fixtures`` (the scripts' scene code,
   cv2 stood in for by the port's PNG writer), one process a format,
   started before the kernels build, into ``build/quality/`` (deleted at
   the end).  Counters zeroed before and read after each run; its kernels
   must launch.  Each run's final eval PSNR must reach its gate (the JAX
   anchor less 0.5 dB; 25.05 dB for the parity field); prints the best
   PSNR, the median step, the wall time and the share of it spent writing
   checkpoints.  On both bear runs, ``--test`` from ``df.pth`` must write
   73 frames and the mp4 or the JAX package's warning, and K1 (at a step
   and density-only) is held against its plain version on that run's
   inputs, dT at (128, 16) and (512, 8) on the flagship's.  After the
   flagship bear run, ``--compact_frac -1``'s auto-tune measures the slab
   fill on its warm grid and prints the fraction it picks beside the
   recipe's 0.35.
10. the ``{"kernels": [...]}`` line (reconstruction, editing, parity and
   quality rows), then the last line ``{"ok": true, "device": {...}}``.

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
        start_params = [p.detach().clone() for p in trainer.field.parameters()]
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
    moved = [float((p.detach() - q).abs().max())
             for p, q in zip(trainer.field.parameters(), start_params)]
    assert all(m > 0 for m in moved), f"a parameter did not move: {moved}"
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


def editing_steps(trainer, opt, n_steps):
    """``n_steps`` editing steps through ``Trainer.train_step``, the launch
    counters zeroed just before and read just after, with CUDA-event stage
    times.  Returns (steps, launches, peak and resident bytes, the last
    step's K1 and dT inputs, the field's largest change, the train
    loader)."""
    import torch
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.models import field
    from customnerf_torch.ops import fused_mlp, triplane, triplane_kernels

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
        for _ in range(n_steps):
            batch = train.item(0)
            refreshed = (opt.cuda_ray
                         and trainer.global_step % opt.update_extra_interval == 0)
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
    assert all(math.isfinite(s[k]) for s in steps
               for k in ("loss", "loss_sds", "loss_bg")), steps
    assert all(e["match_probs"] is not None for e in trainer.pt_dict.values()), \
        "clip_view prompt selection did not run"
    moved = [float((p.detach() - b).abs().max())
             for p, b in zip(trainer.field.parameters(), before)]
    assert all(m > 0 for m in moved), f"the field did not change: {moved}"
    return steps, launches, peak, base_mem, mlp_input, list(dt_calls), max(moved), train


def run_editing(trainer, opt):
    """Phases 5-6: the full-width SD stack, then EDIT_STEPS editing steps
    through ``Trainer.train_step``.  Returns its summary and the kernels'
    inputs of the last step."""
    import torch
    from customnerf_torch.engine import editing
    from customnerf_torch.guidance.layers import n_params
    from customnerf_torch.guidance.sds import FULL_WIDTH_PARAMS

    guidance = trainer.guidance
    editing.prepare_text_embeddings(trainer)
    counts = dict(guidance.param_counts(),
                  clip_view=n_params(trainer.clip_matcher.model))
    assert counts == FULL_WIDTH_PARAMS, (counts, FULL_WIDTH_PARAMS)
    models = (guidance.unet, guidance.vae, guidance.text_encoder.model,
              trainer.clip_matcher.model)
    assert all(p.dtype == torch.float32 and p.is_cuda
               for m in models for p in m.parameters()), "SD stack not f32 on the card"

    steps, launches, peak, base_mem, mlp_input, dt_calls, moved, train = editing_steps(
        trainer, opt, EDIT_STEPS)
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the editing path"
    assert {s["local"] for s in steps} == {True, False}, "an LGIE branch never ran"
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
        "field_max_change": moved,
        "local_steps": sum(s["local"] for s in steps),
        "sd_bounds": sd_bounds(guidance),
        "profile": profile_editing_step(trainer, view),
    }
    return summary, mlp_input, dt_calls


# ------------------------------------------------------------------ parity
# scripts/bear.sh --parity's field flags (-O2: the tiled grid 16 × 2 at 2^21
# rows and desired resolution 8192, 64 + 64 samples: the defaults) on the
# synthetic provider at 16,384 rays a step
PARITY_FLAGS = ("-O2 --num_steps 64 --upsample_steps 64 --data_type synthetic "
                "--h 128 --w 128 --seed 0 --use_ckpt scratch --ckpt scratch").split()
PARITY_WORKSPACE = os.path.join("chiprun_out", "smoke_parity")
PARITY_TABLE_ROWS = 23_967_296          # the 16 levels' rows (ops/grid.py)
PARITY_STEPS = 20
PARITY_EDIT_STEPS = 4
PARITY_SAMPLES = STEP_RAYS * 128          # the fine pass: 64 uniform + 64 pdf
PARITY_COARSE = STEP_RAYS * 64            # the density-only coarse pass
PARITY_STAGES = (("coarse", "start", "coarse"), ("resample", "coarse", "resample"),
                 ("fine", "resample", "fine"), ("composite", "fine", "composite"),
                 ("loss", "composite", "loss"), ("backward", "loss", "backward"),
                 ("adam", "backward", "adam"), ("total", "start", "adam"))


def grid_consistency(x01, table, spec, n=65536):
    """``grid_encode`` on the card against the same call on the CPU, for the
    parity spec and its hash twin (same sizes), on ``n`` of the step's fine
    points: the output and the table gradient (index_add_ atomics on the
    card).  Consistency of the plain encoder, not a kernel check."""
    import dataclasses
    import torch
    from customnerf_torch.ops.grid import grid_encode

    x = x01.reshape(-1, 3)[:n]
    g = torch.randn(x.shape[0], spec.output_dim, generator=torch.Generator().manual_seed(0))
    out = {}
    for gridtype in ("tiled", "hash"):
        s = dataclasses.replace(spec, gridtype=gridtype)
        res = []
        for dev in (x.device, torch.device("cpu")):
            t = table.detach().to(dev).clone().requires_grad_(True)
            enc = grid_encode(x.to(dev), t, s)
            (enc * g.to(dev)).sum().backward()
            res.append((enc.detach().cpu(), t.grad.cpu()))
        errs = {}
        for k, (card, cpu) in zip(("output", "table_grad"), zip(*res)):
            err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
            # the same f32 arithmetic; the card's sums run in another order
            # (the gradient's by atomics): a few ulp of the largest entry
            if not err <= 1e-5 * scale:
                raise AssertionError(f"grid_encode {gridtype} {k}: card vs CPU "
                                     f"{err} > 1e-5 x {scale}")
            errs[k] = {"max_abs_err": err, "scale": scale}
        out[gridtype] = errs
    return out


def run_parity():
    """The parity reconstruction: PARITY_STEPS steps of ``-O2`` on the
    reference field, with CUDA-event stage times, through
    ``Trainer.train_step``.  Counters zeroed just before and read just
    after; K1 must launch (dT is not on this path).  Returns (trainer,
    summary, K1's inputs at the last step's fine and coarse pass, the
    last fine pass's encode inputs)."""
    import torch
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer, psnr
    from customnerf_torch.models import field
    from customnerf_torch.ops import fused_mlp, triplane_kernels
    from customnerf_torch.ops.grid import GridSpec

    opt = parse_args(PARITY_FLAGS + ["--workspace", PARITY_WORKSPACE])
    t0 = time.time()
    trainer = Trainer(opt)
    init_s = time.time() - t0
    spec = trainer.field.cfg.grid
    assert trainer.occ_state is None and trainer.field.fused
    assert isinstance(spec, GridSpec) and spec.table_size == PARITY_TABLE_ROWS
    dev = trainer.device
    train = NeRFDataset(opt, "train", device=dev).dataloader()
    val = NeRFDataset(opt, "val", device=dev).dataloader()
    start_params = [p.detach().clone() for p in trainer.field.parameters()]
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with captured_calls(field, "fused_field_mlp", keep=1,
                        when=lambda a, k: torch.is_grad_enabled()) as at_fine, \
            captured_calls(field, "fused_field_mlp", keep=1,
                           when=lambda a, k: k.get("with_rgb") is False
                           and a[0].shape[0] == PARITY_COARSE) as at_coarse, \
            captured_calls(field, "encode_positions", keep=1,
                           when=lambda a, k: torch.is_grad_enabled()) as enc:
        # the parity path starts here: counters read only its launches
        fused_mlp.fused_mlp_forward.launches = 0
        triplane_kernels.plane_dtable.launches = 0
        t_start = time.time()
        for _ in range(PARITY_STEPS):
            batch = train.item(0)
            trainer.global_step += 1
            events = {}

            def mark(name):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark("start")
            loss, aux, _ = trainer.train_step(batch, mark=mark)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            steps.append(dict({k: events[a].elapsed_time(events[b])
                               for k, a, b in PARITY_STAGES},
                              ms=ms, loss=float(loss)))
        view = val.item(0)
        out = trainer.render_image(view.rays_o, view.rays_d)
        torch.cuda.synchronize()
        wall_s = time.time() - t_start
        launches = {"fused_field_mlp": fused_mlp.fused_mlp_forward.launches,
                    "plane_dtable": triplane_kernels.plane_dtable.launches}
    peak = torch.cuda.max_memory_allocated()

    assert launches["fused_field_mlp"] > 0, "K1 was not launched on the parity path"
    assert all(math.isfinite(s["loss"]) for s in steps), steps
    moved = [float((p.detach() - q).abs().max())
             for p, q in zip(trainer.field.parameters(), start_params)]
    assert all(m > 0 for m in moved), f"a parameter did not move: {moved}"
    del start_params
    img = out["image"]
    assert img.shape == (view.H * view.W, 3) and bool(torch.isfinite(img).all())
    assert at_fine[-1][0][0].shape[0] == PARITY_SAMPLES, at_fine[-1][0][0].shape
    assert at_coarse[-1][0][0].shape[0] == PARITY_COARSE, at_coarse[-1][0][0].shape
    warm = steps[2:]
    summary = {"steps": steps, "launches": launches, "init_s": init_s,
               "wall_s": wall_s, "peak_gb": peak / 1e9,
               "median_ms": {k: statistics.median(s[k] for s in warm)
                             for k in [k for k, _, _ in PARITY_STAGES] + ["ms"]},
               "psnr_val0": psnr(img, view.rgbs.reshape(-1, 3))}
    summary["rays_per_s"] = STEP_RAYS / summary["median_ms"]["ms"] * 1e3
    return trainer, opt, summary, at_fine[-1], at_coarse[-1], enc[-1][0]


def time_grid_encode(x01, table, spec):
    """The grid encode's forward and backward on the step's fine points,
    device times: the backward zeroes the 192 MB table gradient and adds
    each level's corners with index_add_."""
    import torch
    from customnerf_torch.engine.measure import device_ms
    from customnerf_torch.ops.grid import grid_encode

    t = table.detach().clone().requires_grad_(True)
    fwd = device_ms(lambda: grid_encode(x01, t, spec), 5)
    out = grid_encode(x01, t, spec)
    g = torch.randn_like(out)
    bwd = device_ms(lambda: torch.autograd.grad(out, t, g, retain_graph=True), 5)
    B = x01.reshape(-1, 3).shape[0]
    return {"points": B, "forward_ms": fwd, "backward_ms": bwd,
            # one 8-byte corner row per corner and level, read / added
            "corner_rows": B * 8 * spec.num_levels}


def run_reference_checkpoint(trainer, opt):
    """Export the parity field as a reference-format (tcnn) checkpoint,
    load it through ``Trainer(..., use_checkpoint=<file>)`` and render the
    validation view bit for bit as the exporting trainer does."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.convert import params_to_flax
    from customnerf_torch.engine.torch_shim import export_reference_checkpoint
    from customnerf_torch.engine.trainer import Trainer

    path = os.path.join(PARITY_WORKSPACE, "reference_format.pth")
    os.makedirs(PARITY_WORKSPACE, exist_ok=True)
    t0 = time.time()
    export_reference_checkpoint(params_to_flax(trainer.field.state_dict()), path,
                                epoch=trainer.epoch, global_step=trainer.global_step)
    export_s = time.time() - t0
    t0 = time.time()
    loaded = Trainer(opt, use_checkpoint=path, log=lambda *_: None)
    load_s = time.time() - t0
    view = NeRFDataset(opt, "val", device=trainer.device).dataloader().item(0)
    a = trainer.render_image(view.rays_o, view.rays_d)
    b = loaded.render_image(view.rays_o, view.rays_d)
    assert _equal_renders(a, b), "the reference-format round trip renders differently"
    nbytes = os.path.getsize(path)
    del loaded
    os.remove(path)
    return {"bytes": nbytes, "export_s": export_s, "load_s": load_s, "bitwise": True}


def run_parity_editing(recon, guidance, clip_matcher):
    """``scripts/bear.sh --parity`` phase 2 on the synthetic frames: the
    editing flags on ``-O2`` from the parity reconstruction's checkpoint,
    with the SD stack the editing phase built; PARITY_EDIT_STEPS steps."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.engine.trainer import Trainer

    t0 = time.time()
    path = recon.save_checkpoint()
    save_s = time.time() - t0
    nbytes = os.path.getsize(path)
    flags = [f for f in EDIT_FLAGS]
    flags[flags.index("--iters") + 1] = str(PARITY_EDIT_STEPS)
    flags[flags.index("--workspace") + 1] = os.path.join("chiprun_out", "smoke_parity_edit")
    opt = parse_args(PARITY_FLAGS + flags + ["--editing_from", path])
    trainer = Trainer(opt, guidance=guidance, use_checkpoint=opt.ckpt, log=lambda *_: None)
    trainer.clip_matcher = clip_matcher
    assert trainer.occ_state is None
    steps, launches, peak, base_mem, mlp_input, _, moved, _ = editing_steps(
        trainer, opt, PARITY_EDIT_STEPS)
    assert launches["fused_field_mlp"] > 0, "K1 was not launched on the parity editing path"
    assert mlp_input[0][0].shape[0] == PARITY_SAMPLES, mlp_input[0][0].shape
    del trainer
    return {"steps": steps, "launches": launches, "peak_gb": peak / 1e9,
            "resident_before_steps_gb": base_mem / 1e9, "field_max_change": moved,
            "checkpoint_bytes": nbytes, "checkpoint_save_s": save_s,
            "median_ms": {k: statistics.median(s[k] for s in steps) for k in (
                "total", "pt_and_draws", "render_to_latents", "unet", "backward_adam")}}


# ----------------------------------------------------------------- quality
QUALITY_ROOT = os.path.join("build", "quality")
# scripts/bear.sh:31-36, phase 1, with --data_type/--data_path/--workspace
# swapped in by run_quality
BEAR_PHASE1 = ("-O --grid_type triplane --triplane_res 128 512 "
               "--triplane_channels 16 8 --num_steps 40 --upsample_steps 0 "
               "--compact_frac 0.35 --compact_block 64 --keyword lang_bear "
               "--iters 3000 --train_resolution_level 7 "
               "--eval_resolution_level 4 --bound 2 --train_conf 0.01 "
               "--soft_mask --ckpt scratch").split()
# scripts/bear.sh --parity, phase 1: the reference field on the dense path
BEAR_PARITY = ("-O2 --keyword lang_bear --iters 3000 --train_resolution_level 7 "
               "--eval_resolution_level 4 --bound 2 --train_conf 0.01 "
               "--soft_mask --ckpt scratch").split()
# final eval PSNR gates: the JAX package's anchor on each fixture less the
# 0.5 dB band of docs/PARITY.md:151-216 (25.34, 25.01 and 25.28 dB; the
# parity field's 25.55, docs/PARITY.md:166)
QUALITY_GATES = {"nerfstudio": 24.84, "llff": 24.51, "dtu": 24.78}
PARITY_GATE = 25.05
BOTH_KERNELS = ("fused_field_mlp", "plane_dtable")
QUALITY_RUNS = [
    {"name": t, "data_type": t, "flags": BEAR_PHASE1, "gate": g,
     "kernels": BOTH_KERNELS} for t, g in QUALITY_GATES.items()] + [
    {"name": "nerfstudio_parity", "data_type": "nerfstudio", "flags": BEAR_PARITY,
     "gate": PARITY_GATE, "kernels": ("fused_field_mlp",)}]
TEST_FRAMES = 73              # the bear's slerp test path: 3 gaps × 25 − 2


def start_fixtures():
    """One writer process a format (the scripts' scene code with the PNG
    stand-in for cv2), started while the kernels build."""
    import subprocess
    shutil.rmtree(QUALITY_ROOT, ignore_errors=True)
    os.makedirs(QUALITY_ROOT)
    return {t: subprocess.Popen(
        [sys.executable, "-m", "customnerf_torch.data.fixtures", QUALITY_ROOT,
         "--data_type", t], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for t in QUALITY_GATES}


def wait_fixture(proc, data_type):
    """The fixture's directory, once its writer has finished."""
    from customnerf_torch.data.fixtures import WRITERS
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"fixture {data_type} failed:\n{out[-2000:]}")
    return os.path.join(QUALITY_ROOT, WRITERS[data_type][0])


def run_quality(run, data_path, capture_k1=False, capture_dt=False,
                autotune=False):
    """One ``QUALITY_RUNS`` entry through ``customnerf_torch.__main__.main``
    on its fixture: 3000 steps, an evaluation each epoch, then the test path.
    Returns its summary and the kernels' inputs it captured: K1 at a step's
    full head and at a density-only call inside a step (the ``-O``
    refresh, the ``-O2`` coarse pass), the last step's dT calls.  The
    summary splits out the time spent writing checkpoints; with
    ``autotune``, the ``--compact_frac -1`` auto-tune's measured fill and
    chosen fraction on the trained grid."""
    import contextlib
    import torch
    from customnerf_torch.__main__ import main as cli
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import checkpoint as ckpt_io
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.models import field
    from customnerf_torch.ops import fused_mlp, triplane, triplane_kernels

    name, data_type, base_flags = run["name"], run["data_type"], run["flags"]
    ws = os.path.join(QUALITY_ROOT, f"ws_{name}")
    flags = base_flags + ["--data_type", data_type, "--data_path", data_path,
                          "--workspace", ws]
    step_ms, in_step, saves = [], [False], {"ring_s": 0.0, "best_s": 0.0, "bytes": 0,
                                           "files": 0}
    train_step, save_ring, save_file = (Trainer.train_step, Trainer.save_checkpoint,
                                        ckpt_io.save_checkpoint)

    def timed_step(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        in_step[0] = True
        out = train_step(self, *a, **kw)
        in_step[0] = False
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_ring(self, *a, **kw):
        t0 = time.perf_counter()
        path = save_ring(self, *a, **kw)
        saves["ring_s"] += time.perf_counter() - t0
        return path

    def timed_file(path, *a, **kw):
        t0 = time.perf_counter()
        out = save_file(path, *a, **kw)
        if os.path.basename(path) == "df.pth":       # the best result's file
            saves["best_s"] += time.perf_counter() - t0
        saves["bytes"] += os.path.getsize(path)
        saves["files"] += 1
        return out

    def quiet(msg):
        if msg.startswith(("++> eval PSNR", "[WARN]")):
            log(f"[quality {name}] {msg}")

    with contextlib.ExitStack() as stack:
        if capture_k1:
            at_step = stack.enter_context(captured_calls(
                field, "fused_field_mlp", keep=1,
                when=lambda a, k: torch.is_grad_enabled()))
            at_density = stack.enter_context(captured_calls(
                field, "fused_field_mlp", keep=1,
                when=lambda a, k: k.get("with_rgb") is False and (
                    in_step[0] or base_flags[0] == "-O")))
        if capture_dt:
            dt_calls = stack.enter_context(captured_calls(triplane, "plane_dtable",
                                                          keep=6))
        Trainer.train_step, Trainer.save_checkpoint = timed_step, timed_ring
        ckpt_io.save_checkpoint = timed_file
        stack.callback(setattr, Trainer, "train_step", train_step)
        stack.callback(setattr, Trainer, "save_checkpoint", save_ring)
        stack.callback(setattr, ckpt_io, "save_checkpoint", save_file)
        # this path starts here: counters read only its launches
        fused_mlp.fused_mlp_forward.launches = 0
        triplane_kernels.plane_dtable.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        trainer = cli(flags, log=quiet)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        launches = {"fused_field_mlp": fused_mlp.fused_mlp_forward.launches,
                    "plane_dtable": triplane_kernels.plane_dtable.launches}

    results = trainer.stats["results"]
    final, best = -results[-1], -trainer.stats["best_result"]
    strips = sorted(os.listdir(os.path.join(ws, "validation")))
    ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    test_dir = os.path.join(ws, "results", f"df_ep{trainer.epoch:04d}_test")
    ckpt_s = saves["ring_s"] + saves["best_s"]
    summary = {"name": name, "data_type": data_type, "final_psnr": final,
               "best_psnr": best, "psnr_by_epoch": [-r for r in results],
               "steps": len(step_ms), "median_step_ms": statistics.median(step_ms),
               "mean_step_ms": statistics.mean(step_ms), "wall_s": wall_s,
               "checkpoint_s": ckpt_s, "checkpoint_share": ckpt_s / wall_s,
               "checkpoint_files": saves["files"], "checkpoint_bytes": saves["bytes"],
               "validation_strips": len(strips), "checkpoints": ckpts,
               "test_frames": len(os.listdir(test_dir)), "launches": launches,
               "gate": run["gate"], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    for kernel in run["kernels"]:
        assert launches[kernel] > 0, f"{kernel} was not launched on the {name} path"
    assert len(step_ms) == trainer.global_step >= trainer.opt.iters, len(step_ms)
    assert "df.pth" in ckpts and len(strips) == trainer.epoch, (ckpts, strips)
    inputs = {}
    if capture_k1:
        inputs.update(step=at_step[-1], density=at_density[-1])
    if capture_dt:
        inputs["dtable"] = list(dt_calls)
    if autotune:
        # --compact_frac -1 on the trained, warm grid: what it would pick
        from customnerf_torch.ops.occupancy import WARMUP_UPDATES
        assert trainer.occ_state.iter_density > WARMUP_UPDATES, "the grid is not warm"
        fills, measure = [], trainer.measure_slab_fill
        trainer.measure_slab_fill = lambda batch: fills.append(measure(batch)) or fills[-1]
        recipe = trainer.opt.compact_frac
        trainer.opt.compact_frac = -1
        trainer._autotune_compaction(
            NeRFDataset(trainer.opt, "train", device=trainer.device).dataloader())
        summary["autotune"] = {"slab_fill": fills[0], "compact_frac": trainer.opt.compact_frac,
                               "recipe_compact_frac": recipe,
                               "compact_block": trainer.opt.compact_block}
        assert len(fills) == 1 and 0.0 <= trainer.opt.compact_frac <= 1.0, summary["autotune"]
    del trainer
    return summary, inputs


def run_test_render(run, data_path):
    """``--test`` from the best checkpoint ``df.pth``: one PNG a pose of the
    test path, and the mp4 where cv2 can write it, else the JAX package's
    warning."""
    from customnerf_torch.__main__ import main as cli
    ws = os.path.join(QUALITY_ROOT, f"ws_{run['name']}")
    lines = []
    t0 = time.time()
    trainer = cli(run["flags"] + ["--data_type", run["data_type"], "--data_path",
                                  data_path, "--workspace", ws, "--test", "--ckpt",
                                  os.path.join(ws, "checkpoints", "df.pth")],
                  log=lines.append)
    wall_s = time.time() - t0
    name = f"df_ep{trainer.epoch:04d}_test"
    frames = os.listdir(os.path.join(ws, "results", name))
    mp4 = os.path.join(ws, "results", f"{name}_rgb.mp4")
    warn = [l for l in lines if l.startswith("[WARN] mp4 write failed")]
    return {"frames": len(frames), "epoch": trainer.epoch, "wall_s": wall_s,
            "mp4_bytes": os.path.getsize(mp4) if os.path.exists(mp4) else None,
            "mp4_warning": warn[0] if warn else None}


def quality_phase(procs):
    """The QUALITY_RUNS through bear.sh phase 1 (three fixtures on the
    flagship field, the bear on ``--parity``'s); the gates; --test on both
    bear runs; K1 (and on the flagship dT) against their plain versions on
    the bear runs' inputs; the auto-tune on the flagship bear's grid."""
    runs, rows, paths = {}, [], {}
    for run in QUALITY_RUNS:
        name, data_type = run["name"], run["data_type"]
        t0 = time.time()
        if data_type not in paths:
            paths[data_type] = wait_fixture(procs[data_type], data_type)
        waited = time.time() - t0
        bear = data_type == "nerfstudio"
        flagship = run["flags"][0] == "-O"
        summary, inputs = run_quality(run, paths[data_type], capture_k1=bear,
                                      capture_dt=bear and flagship,
                                      autotune=bear and flagship)
        summary["fixture_wait_s"] = waited
        log(f"[quality {name}] final eval PSNR {summary['final_psnr']:.2f} dB "
            f"(best {summary['best_psnr']:.2f}, gate >= {summary['gate']}) | median "
            f"step {summary['median_step_ms']:.2f} ms over {summary['steps']} | wall "
            f"{summary['wall_s']:.1f} s, checkpoints {summary['checkpoint_s']:.1f} s "
            f"({100 * summary['checkpoint_share']:.1f} %, {summary['checkpoint_files']} "
            f"files, {summary['checkpoint_bytes'] / 1e9:.2f} GB) | "
            f"{summary['validation_strips']} strips | peak {summary['peak_gb']:.2f} GB "
            f"| launches {summary['launches']}")
        if "autotune" in summary:
            a = summary["autotune"]
            log(f"[autotune {name}] measured slab fill {a['slab_fill']:.4f} on the "
                f"trained grid -> --compact_frac {a['compact_frac']:.4f} (block "
                f"{a['compact_block']}); the recipe fixes {a['recipe_compact_frac']}")
        if bear:
            summary["test"] = run_test_render(run, paths[data_type])
            t = summary["test"]
            video = (f"mp4 written ({t['mp4_bytes']} bytes)" if t["mp4_bytes"]
                     else t["mp4_warning"])
            log(f"[quality {name}] --test from df.pth (epoch {t['epoch']}): "
                f"{t['frames']} PNG frames in {t['wall_s']:.1f} s; {video}")
            assert t["frames"] == TEST_FRAMES, t
            assert t["mp4_bytes"] or t["mp4_warning"], "--test: no mp4 and no warning"
            run_rows = [check_fused_mlp(*inputs["step"][0], **inputs["step"][1]),
                        check_fused_mlp(*inputs["density"][0], **inputs["density"][1])]
            if flagship:
                run_rows += [check_dtable(*inputs["dtable"][i][0][:7]) for i in (0, 3)]
            for r in run_rows:
                r["launches"] = summary["launches"][r["name"]]
                r["path"] = f"quality {name}"
            rows += run_rows
        runs[name] = summary
        # the workspace (≈ 10 checkpoints) has served its purpose
        shutil.rmtree(os.path.join(QUALITY_ROOT, f"ws_{name}"), ignore_errors=True)
    for name, summary in runs.items():
        if not summary["final_psnr"] >= summary["gate"]:
            raise AssertionError(
                f"{name}: final eval PSNR {summary['final_psnr']:.3f} dB "
                f"is under its gate {summary['gate']} dB")
    return runs, rows


def parity_phase(card, guidance, clip_matcher):
    """The parity reconstruction, K1 on its inputs, the grid encode's times
    and its card/CPU consistency, the reference-format round trip and the
    parity editing steps.  Returns the summary and the kernel rows."""
    recon, opt, pa, fine, coarse, enc_args = run_parity()
    med = pa["median_ms"]
    log(f"[parity] {card} | {PARITY_STEPS} -O2 steps of {STEP_RAYS} rays on the "
        f"reference grid (16 x 2 at 2^21 rows, 23,967,296 x 2 table) | median "
        f"{med['ms']:.2f} ms/step = {pa['rays_per_s']:.0f} rays/s | coarse "
        f"{med['coarse']:.2f}, sample_pdf + sort {med['resample']:.2f}, fine "
        f"{med['fine']:.2f}, composites {med['composite']:.2f}, loss {med['loss']:.2f}, "
        f"backward {med['backward']:.2f}, Adam {med['adam']:.2f} ms | peak "
        f"{pa['peak_gb']:.2f} GB | init {pa['init_s']:.1f} s | launches "
        f"{pa['launches']} | val view PSNR {pa['psnr_val0']:.2f} dB")
    rows = [check_fused_mlp(*fine[0], **fine[1]), check_fused_mlp(*coarse[0], **coarse[1])]
    for r in rows:
        r["launches"] = pa["launches"][r["name"]]
        r["path"] = "parity reconstruction"
    pa["grid_encode"] = ge = time_grid_encode(*enc_args)
    log(f"[parity grid] encode of the fine pass's {ge['points']} points: forward "
        f"{ge['forward_ms']:.2f} ms, backward {ge['backward_ms']:.2f} ms (device "
        f"times, {ge['corner_rows']} corner rows)")
    pa["grid_consistency"] = gc = grid_consistency(*enc_args)
    log("[parity grid] card vs CPU on 65,536 points: " + "; ".join(
        f"{t} output {e['output']['max_abs_err']:.3g}, table gradient "
        f"{e['table_grad']['max_abs_err']:.3g}" for t, e in gc.items()))
    ref = run_reference_checkpoint(recon, opt)
    log(f"[reference checkpoint] tcnn-format export {ref['bytes']} bytes in "
        f"{ref['export_s']:.1f} s; loaded through --ckpt in {ref['load_s']:.1f} s; "
        f"renders the validation view bit for bit")
    ed = run_parity_editing(recon, guidance, clip_matcher)
    em = ed["median_ms"]
    log(f"[parity editing] {card} | {PARITY_EDIT_STEPS} steps of {STEP_RAYS} rays "
        f"from a {ed['checkpoint_bytes']} byte checkpoint (saved in "
        f"{ed['checkpoint_save_s']:.1f} s) | median {em['total']:.1f} ms/step: pt + "
        f"draws {em['pt_and_draws']:.1f}, render to latents "
        f"{em['render_to_latents']:.1f}, UNet {em['unet']:.1f}, backward + Adam "
        f"{em['backward_adam']:.1f} | peak {ed['peak_gb']:.2f} GB | launches "
        f"{ed['launches']}")
    del recon
    for ws in (PARITY_WORKSPACE, os.path.join("chiprun_out", "smoke_parity_edit")):
        shutil.rmtree(ws, ignore_errors=True)
    return {"reconstruction": pa, "reference_checkpoint": ref, "editing": ed}, rows


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

    procs = start_fixtures()
    try:
        return run_all(card, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(QUALITY_ROOT, ignore_errors=True)


def run_all(card, procs) -> int:
    import torch
    from customnerf_torch.ops import kernels

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

    # the checkpoint (~180 MB with its Adam state) has served its purpose
    shutil.rmtree(RECON_WORKSPACE, ignore_errors=True)
    guidance, clip_matcher = editor.guidance, editor.clip_matcher
    del editor
    parity, parity_rows = parity_phase(card, guidance, clip_matcher)
    del guidance, clip_matcher
    rows += parity_rows

    quality, quality_rows = quality_phase(procs)
    rows += quality_rows
    for r in rows:
        log(f"[kernel] {r['path']} {r['name']} {r['shape']}: err {r['max_abs_err']:.3g} "
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
                   "ptxas": kernels.ptxas_log, "kernels": rows, "trainer": tr,
                   "checkpoint": ck, "editing": ed, "parity": parity,
                   "quality": quality},
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
