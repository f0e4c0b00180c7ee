#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``customnerf_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) if anything is wrong:

1. setup: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the kernels built from ``customnerf_torch/csrc`` (seconds).
2. trainer (the main path): the flagship reconstruction recipe
   (``config.FLAGSHIP_ARGS``, ``scripts/bear.sh:18-20``) with ``--backend
   pallas`` (the JAX package's Pallas route: the f32 fused head; dT keeps
   its default bf16 operands) on the synthetic provider at 128×128 = 16,384
   rays a step, through the port's ``Trainer``, with the occupancy grid
   refreshed every 4 steps so that it leaves its warm-up.  The launch
   counters (one a kernel mode) are zeroed just before and read just after;
   K1's f32 mode and dT's bf16 mode must have run and no other mode, and
   the refresh must have taken the density-only head.  Then 4 more steps
   with the tri-plane spec's ``mm_bf16`` off (counters zeroed and read
   again): dT's f32 mode must launch.  Every loss must be finite and every parameter must
   have moved; the loss on a fixed view is printed before and after (on
   this scene it does not fall within 40 steps from the flax init: the
   quality phase checks learning, with PSNR gates); one validation view is
   rendered through ``render_image`` and its PSNR printed.
3. kernels: each hand-written kernel, in the mode the path ran, against
   its plain PyTorch version on the inputs the path gave it — the fused
   field MLP on one train step's 229,376 compacted samples and,
   density-only, on one refresh's 4,194,304 queries (whose sigma must equal
   the full head's bit for bit), the tri-plane table gradient on the XY
   plane of each level ((R, C) = (128, 16) and (512, 8)) of the last train
   step, in bf16 and, from the steps with ``mm_bf16`` off, in f32 — with
   CUDA-event device times (``engine/measure.py``) of the kernel, of the
   other mode's kernel on the same inputs, of the plain version and, where
   one exists, of a single library call.  Tolerances: K1-f32 1e-4 and
   K1-bf16 1e-2 of the largest output, dT 1e-5 of the largest texel sum in
   either mode.  These launches come after the counters were read.
4a. K steps a dispatch (``--steps_per_dispatch``, 8 on the card): a
   flagship trainer (the default policy) loads phase 4's checkpoint (its
   grid warm) and, from one saved state (parameters, Adam state, update
   counter, generator), takes 24 eager steps (twice, and once more on a
   side stream: the card's own spread), then the same 24 steps as 3
   dispatches of K = 8 (one captured CUDA graph of a step, replayed; then
   again, replays only): per-step losses within 1e-2 relative, every
   parameter within 2·lr_g a step, within 1e-2·lr_g a step in RMS and
   within 8 times the spread's RMS (floor 1e-4·lr_g a step; the card's
   atomic sums run in another order, and Adam's ±lr steps flip where a
   gradient is near zero); each kernel mode launched, as the kernels count
   on the card, exactly (steps + warm-up)/steps times as often, the
   wrappers counting the warm-up steps only, and the replays-only run
   exactly as often; median ms a step of both, the capture's ms, peaks and the
   tracer's graphed split of a dispatch (``engine/step_profile.py::graphed_split``);
   K1-bf16 and dT-bf16 held against their plain versions on the inputs the
   captured step holds after its last replay.  The same check runs on the
   parity step (8b: 16 steps, 2 dispatches), the editing step and the
   ``--use_cd`` editing step (8 steps, one dispatch; losses within 5e-2:
   the render's differences pass through the SD stack's bf16 at cfg 100).
4d. checkpoints, on the flagship state of 4a (~180 MB with Adam) and the
   parity state (8b, 575 MB): the ms a save holds the training thread,
   synchronous against ``--ckpt_format orbax``'s ``AsyncSaver`` (first
   save, with its pinned buffers, and a later one); an asynchronous file
   written while a dispatch of steps ran reloads bit for bit as the state
   at the save; a write that cannot land (its directory under a file)
   raises at ``wait()``.
4. checkpoint: the trainer of phase 2 saves its checkpoint into
   ``chiprun_out/``; an editing trainer (``scripts/bear.sh``'s phase-2
   flags, ``--editing_from`` that file: bf16 heads) is built from it; its
   frozen field must hold the saved parameters bit for bit and, in the
   saving trainer's f32 head, render the validation view bit for bit as the
   saving trainer does (``perturb=False``, the restored occupancy grid equal
   to the saved).
5. full width: the SD 1.5 stack (UNet, VAE, CLIP ViT-L/14 text, CLIP
   ViT-B/32 matcher) is built on the card from a seeded generator, UNet and
   VAE stored in bf16, the text towers in f32 (the JAX package's rule), and
   its parameter counts must equal the JAX package's
   (``guidance/sds.py::FULL_WIDTH_PARAMS["1.x"]``, pinned by a CPU test).
6. editing (the second path): 8 LGIE/SDS steps on the same 128×128 frames
   (16,384 rays a step).  Counters zeroed just before and read just after;
   K1's and dT's bf16 modes must have launched, both LGIE branches and the clip_view
   prompt selection must have run, every loss must be finite and the field
   must have changed.  Prints the step's median ms and its split (render to
   latents, UNet, backward + Adam), its peak memory, the SD stack's init
   seconds and the frozen pt render's ms.
7. kernels on the editing inputs: K1 on the last editing step's render and
   dT at (128, 16) and (512, 8) on its backward, against their plain
   versions, with the live-sample share.
7a. multi-scene editing (N scenes × M prompts,
   ``engine/editing.py::editing_step_scenes``), on the editing trainer of
   phase 6 (phase 4's checkpoint, the full-width SD 1.5 stack in bf16):
   S = 2 scenes from its state, each with its own prompt pair and its own
   copy of the occupancy grid, 4 steps (after one that fills each scene's pt
   entry).  Every loss finite, every scene's field moved; the counters
   zeroed before and read after: each kernel mode launched, as the kernels
   count on the card, exactly 2× as often a step as one eager single-scene
   step (counted alike just before); K1-bf16 and dT against their plain
   versions on the last step's inputs; one S = 2 step against two
   single-scene steps from one saved state with the same draws (bg colour,
   t, both noises, the scenes' generators and gates): ``loss_sds`` and
   ``loss_bg`` within 5e-2 relative, the editing dispatch check's
   tolerance (the UNet runs in bf16 at batch 4 against 2: cfg 100 scales its
   roundings).  Prints the ms a step at S = 2 and S = 4 against S eager
   single-scene steps, the UNet stage's ms at batch 2S against batch 2
   (CUDA events at the stage marks), and the peak GB.
7b'. the ``data`` axis: two processes on the one card (``gloo``: not a
   card per rank, ``parallel/mesh.py::choose_backend``) each run this file
   as a worker (``--data-axis-worker``): the flagship (the default policy)
   from phase 4's checkpoint under ``--mesh_shape data:2``, 4 eager steps of
   16,384 rays (each rank 8,192: 128 whole compaction blocks of 64) and one
   ``render_image`` of a validation view, against this process running the
   same from the same checkpoint without a mesh: losses within 1e-2
   relative, every parameter within 2·lr_g a step and its RMS distance
   within 1e-2·lr_g a step (phase 4a's rules; the ranks' atomic sums and
   the gradient sum run in another order), the view within 2e-2 of the
   largest pixel error and 1e-3 mean.  Rank 0's counters: K1-bf16 and
   dT-bf16 must launch; both are held against their plain versions on rank
   0's inputs.  The ms a step is printed; it is not a speed figure (both
   ranks share the card, and gloo goes through the host).
7b. image-driven editing, on the stack of phase 5 and the checkpoint of
   phase 4: 4 synthetic frames at 128×128 written as JPEG
   (``utils/jpeg.py::write_jpeg``) are the concept images; ``retrieve``
   generates 2 class images (25 DDIM steps at 512², seconds per image);
   ``train_custom_diffusion`` takes 8 steps at full width in bf16 (batch 2
   with prior, a checkpoint at step 4, one validation sample at step 8;
   median step, peak memory, artifact bytes; every loss finite, every
   adapter and the token row moved), and a second call resumes from
   ``latest`` and must end within 1e-3 (relative L2 of the change) of the
   straight run's adapters; then 8 ``--use_cd`` editing steps with
   ``<new1>`` in the prompts (ε with the adapters must differ from ε
   without; counters zeroed before and read after, both kernels must
   launch) and K1 / dT held against their plain versions on that path's
   inputs.  Then the weights drill: ``customnerf_torch.__main__.main(
   ["--validate_weights", ...])`` at full width must exit 0 with ``ok`` and
   the parameter counts of ``FULL_WIDTH_PARAMS["1.x"]``.
8. parity: ``scripts/bear.sh --parity``'s field on the
   synthetic provider — ``-O2``, the reference tiled grid (16 levels × 2
   channels at 2^21 rows, desired resolution 8192: a 23,967,296 × 2
   table), 64 + 64 samples, 16,384 rays a step, 20 steps through
   ``Trainer.train_step`` with CUDA-event stage times (coarse encode + K1
   density-only, ``sample_pdf`` + sort, fine encode + K1, composites,
   loss, backward, Adam), the median step, rays/s and peak memory.
   Counters zeroed before and read after; K1's bf16 mode and both grid
   encode kernels must launch.  Every loss
   finite, every parameter moved.  K1 is held against its plain version on
   the last step's 2,097,152 fine and 1,048,576 coarse (density-only)
   samples; the grid encode's kernels against the plain encoder on the
   card (coarse forward, fine forward, fine backward: kernel, plain,
   library and bound ms), and ``grid_encode`` on the card against the same
   call on the CPU (tiled and hash, 65,536 points).  The field is exported as a
   reference-format (tcnn) checkpoint and loaded through
   ``Trainer(use_checkpoint=...)``: it must render bit for bit.  Then
   ``bear.sh --parity`` phase 2: 4 editing steps on ``-O2`` from the parity
   reconstruction's checkpoint, with the SD stack of phase 5 (stage
   times, peak memory); K1 and the grid kernels must launch.
8c. SD 2.x (``--sd_version 2.1``), once the SD 1.5 stack is freed: the
   full-width 2.1 stack on the card (UNet 865,910,724 and OpenCLIP ViT-H
   text 340,387,840 parameters, ``FULL_WIDTH_PARAMS["2.x"]``; UNet and VAE
   bf16, text tower and CLIP view matcher f32); phase 6 again under 2.1
   from phase 4's checkpoint (8 LGIE steps with stage times, the profiled
   step, ``sd_bounds`` at the 1024-wide context, K1 and dT on its inputs,
   one dispatch of K = 8 against eager steps under ``dispatch_check``'s
   rule); then 4 concept frames written as progressive JPEGs by cv2 (a
   witness: the port does not use it) whose decode must equal
   ``cv2.imread`` bit for bit, one DDIM class image, the decoder's seconds
   a megapixel on baseline and progressive copies of it, 4 tuning steps
   (adapters [C, 1024], a 1024-wide token row), 4 ``--use_cd`` editing
   steps with K1 and dT rows, and the weights drill under 2.1.  Each line
   stands beside SD 1.5's number of this run.
9. quality (the third path): ``scripts/bear.sh`` phase 1's flags (3000
   steps, an evaluation each epoch, then the test path) through
   ``customnerf_torch.__main__.main`` on the repo's bear (nerfstudio, 28
   views), LLFF and DTU (24 views each) fixtures at 400×300, and
   ``bear.sh --parity`` phase 1 on the bear.  The fixtures are written by
   ``python -m customnerf_torch.data.fixtures`` (the scripts' scene code,
   cv2 stood in for by the port's PNG writer), one process a format,
   started before the kernels build, into ``build/quality/`` (deleted at
   the end); the flagship bear run reads the reference layout, its images
   as JPEG (the PNGs encoded by ``write_jpeg`` at quality 95) and its masks
   as PNG, with the decode seconds of the 28 views and the JPEGs' PSNR
   against the PNGs printed; LLFF, DTU and the parity bear read PNG.
   The runs take the card's default K = 8 (dispatches of 8 steps, the
   refresh moved by the JAX rule); the parity bear writes its checkpoints
   with ``--ckpt_format orbax``.  Counters zeroed before and read after
   each run (the kernels' own counts on the card, which see the replays);
   its kernels must launch.  Each run's final eval PSNR must reach its gate (the JAX
   anchor less 0.5 dB; 25.05 dB for the parity field); prints the best
   PSNR, the median step (a dispatch's ms over its steps), the wall time
   and the share of it that saves held the training thread (writes, or
   snapshots and waits when asynchronous).  On both bear runs, ``--test`` from ``df.pth`` must write
   73 frames and the mp4 or the JAX package's warning, and K1 (at a step
   and density-only) is held against its plain version on that run's
   inputs, dT at (128, 16) and (512, 8) on the flagship's.  After the
   flagship bear run, ``--compact_frac -1``'s auto-tune measures the slab
   fill on its warm grid and prints the fraction it picks beside the
   recipe's 0.35.
10. host inputs (the card's host; the host library ``csrc/host/*.cpp`` is
   built by the host compiler beside the kernels): (a) every JPEG file
   the phases above decoded (their bytes kept as they were read: the
   concept images, the SD 2.x progressive concept images, the bear's 28
   JPEG views) and 12 progressive files written here by cv2 with scans
   dropped (4:2:0, 4:4:4, gray and a restart interval; the last
   refinement, the luma's AC-first scan and what follows it, every AC scan
   of one component) at 240×320: the host library's coefficients equal
   the plain Python loops', each file's decode equals ``cv2.imdecode`` bit
   for bit (the smoothed files under whichever smoothing row rule cv2's
   libjpeg-turbo has; the 4:4:4 and gray ones under both), and the
   seconds a megapixel of both paths, whole-file and entropy stage alone,
   are printed; (b) the committed JAX-written ``.orbax`` fixture
   (``tests/data/jax_orbax``) copied into a workspace's ``checkpoints/``:
   its read (ms, MB/s of decompressed data), a trainer on its flags (the
   default policy) resumed by ``--ckpt latest`` equal bit for bit to the
   ``.npz`` (parameters, occupancy), then 8 steps as one graphed dispatch
   with the counters zeroed before and read after (K1 and dT rows on the
   graph's inputs); (c) the fixture as ``--editing_from``: the pt image
   equals the one from a ``.pth`` of the same arrays bit for bit.
11. the ``{"kernels": [...]}`` line (reconstruction, editing, ``--use_cd``
   editing, parity, SD 2.x, quality, ``.orbax`` resume and the graph
   paths' rows; all four kernel modes; rows of the multi-scene and
   ``data:2`` paths), then the last line ``{"ok": true, "device": {...}}``.

Every phase but the 40-step reconstruction runs the JAX package's default
precision for its flags: bf16 heads through K1's bf16 mode, dT's bf16
operands, the SD stack in bf16.

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

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 on the
# tensor cores, f32 outside them, and HBM3 bandwidth.  bound_ms =
# max(operations / the peak of the unit that runs them, bytes / HBM).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3               # K1 runs each f32 product as three TF32 products

SMOKE_FLAGS = ("--data_type synthetic --h 128 --w 128 "
               "--seed 0 --update_extra_interval 4 --use_ckpt scratch "
               "--ckpt scratch").split()
# the 40-step reconstruction runs the JAX package's Pallas route: the f32
# fused head (every other phase runs the default policy: bf16 heads)
RECON_FLAGS = ["--backend", "pallas"]
DT_F32_STEPS = 4              # steps with the tri-plane spec's mm_bf16 off
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


def _with(flags, **values):
    """``flags`` with the values of some options replaced."""
    out = list(flags)
    for name, value in values.items():
        out[out.index("--" + name) + 1] = value
    return out


# the SD 2.x phase: the same editing recipe under --sd_version 2.1
SD2_VERSION = "2.1"
SD2_WORKSPACE = os.path.join(os.path.dirname(RECON_WORKSPACE), "smoke_sd2")
SD2_EDIT_FLAGS = _with(EDIT_FLAGS, sd_version=SD2_VERSION,
                       workspace=os.path.join(SD2_WORKSPACE, "edit"))
SD2_TUNE_STEPS, SD2_CLASS_IMAGES, SD2_CD_EDIT_STEPS = 4, 1, 4
STEP_RAYS = 128 * 128
STEP_SAMPLES = 229_376        # 256 blocks × 896 slots
REFRESH_QUERIES = 2 * 128 ** 3


def log(msg):
    print(msg, flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the four kernel modes and the grid encode's two kernels, by the names of
# the {"kernels": ...} line
K1, K1_BF16, DT, DT_BF16 = ("fused_field_mlp", "fused_field_mlp_bf16",
                            "plane_dtable", "plane_dtable_bf16")
GRID, GRID_BWD = "grid_encode", "grid_encode_bwd"
# the grid field's paths (--parity): K1's bf16 mode and both grid kernels
GRID_PATH = (K1_BF16, GRID, GRID_BWD)


def zero_counts():
    """Set every launch count to 0 (just before a path is driven): the
    wrappers' and the kernels' own counts on the card."""
    from customnerf_torch.ops import fused_mlp, grid, kernels, triplane_kernels
    for fn in (fused_mlp.fused_mlp_forward, triplane_kernels.plane_dtable):
        fn.launches = fn.launches_bf16 = 0
    grid.grid_encode.launches = grid.grid_encode.launches_bwd = 0
    kernels.reset_device_launches()


def read_wrapper_counts():
    """Each kernel mode's launches since :func:`zero_counts` as its wrapper
    counted them: eager launches only (a replayed graph runs no wrapper)."""
    from customnerf_torch.ops import fused_mlp, grid, triplane_kernels
    mlp, dt = fused_mlp.fused_mlp_forward, triplane_kernels.plane_dtable
    enc = grid.grid_encode
    return {K1: mlp.launches, K1_BF16: mlp.launches_bf16,
            DT: dt.launches, DT_BF16: dt.launches_bf16,
            GRID: enc.launches, GRID_BWD: enc.launches_bwd}


def read_counts(graphed=False):
    """Each kernel mode's launches since :func:`zero_counts`, as the kernel
    counted them on the card (``ops/kernels.py::device_launches``), a
    replayed graph's included.  On an eager path they must equal the
    wrappers' counts; on a ``graphed`` one the wrappers counted only the
    eager launches (warm-up steps, evaluation renders): no more than the
    kernels."""
    from customnerf_torch.ops import kernels
    k1, k1_bf16 = kernels.device_launches("fused_mlp")
    dt, dt_bf16 = kernels.device_launches("plane_dtable")
    fwd, bwd = kernels.device_launches("grid_encode")
    device = {K1: k1, K1_BF16: k1_bf16, DT: dt, DT_BF16: dt_bf16, GRID: fwd,
              GRID_BWD: bwd}
    wrappers = read_wrapper_counts()
    for name, n in device.items():
        assert (wrappers[name] <= n) if graphed else (wrappers[name] == n), \
            f"{name}: the wrapper counted {wrappers[name]}, the kernel {n} launches"
    return device


def check_launched(launches, kernels, path):
    """The modes a path must have launched have, and no other mode has."""
    for name, n in launches.items():
        assert (n > 0) == (name in kernels), \
            f"{name} launched {n} times on the {path} path (expected: {kernels})"


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
    from customnerf_torch.ops import triplane
    from customnerf_torch.ops.occupancy import WARMUP_UPDATES

    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + RECON_FLAGS
                     + ["--workspace", RECON_WORKSPACE])
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
        zero_counts()
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
        launches = read_counts()

    img = out["image"]
    assert img.shape == (view.H * view.W, 3), img.shape
    assert bool(torch.isfinite(img).all()), "non-finite render"
    view_psnr = psnr(img, view.rgbs.reshape(-1, 3))
    losses = [s["loss"] for s in steps]
    assert all(math.isfinite(v) for v in losses + [loss_before, loss_after]), losses
    moved = [float((p.detach() - q).abs().max())
             for p, q in zip(trainer.field.parameters(), start_params)]
    assert all(m > 0 for m in moved), f"a parameter did not move: {moved}"
    check_launched(launches, (K1, DT_BF16), "main")
    steady = [s for s in steps if s["warm"]]
    assert steady, "the occupancy grid never left its warm-up"
    assert statistics.mean(s["overflow_frac"] for s in steady) < 1.0, \
        "every block overflowed: the compacted path never ran exactly"
    for n, (args, _) in mlp_inputs.items():
        assert args[0].shape[0] == n, (n, args[0].shape)
    assert mlp_inputs[REFRESH_QUERIES][1].get("with_rgb") is False, \
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


DISPATCH_WORKSPACE = os.path.join("chiprun_out", "smoke_dispatch")


def run_flagship_dispatch(ckpt_path):
    """(a) The flagship (``config.FLAGSHIP_ARGS``, the default policy) from
    the main path's checkpoint (its grid warm): 24 eager steps against 3
    dispatches of K = 8 (:func:`dispatch_check`), K1 and dT held against
    their plain versions on the graph's inputs; then (d) the checkpoint
    blocking times on this state (~180 MB with Adam)."""
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.ops.occupancy import WARMUP_UPDATES

    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + ["--workspace", DISPATCH_WORKSPACE])
    tr = Trainer(opt, use_checkpoint=ckpt_path, log=lambda *_: None)
    assert tr.occ_state.iter_density > WARMUP_UPDATES and tr.n_updates > 0
    assert tr.steps_per_dispatch() == GRAPH_K
    train = NeRFDataset(opt, "train", device=tr.device).dataloader()
    batches = [train.item(i % len(train)) for i in range(FLAGSHIP_DISPATCHES * GRAPH_K)]
    summary, mlp, dt = dispatch_check(tr, batches, "reconstruction", "flagship dispatch (graph)")
    check_launched(summary["graph_launches"], (K1_BF16, DT_BF16), "flagship dispatch")
    rows = dispatch_rows(mlp, dt, summary)
    try:
        summary["checkpoint"] = checkpoint_blocking(tr, batches[:GRAPH_K], "flagship")
    finally:
        shutil.rmtree(DISPATCH_WORKSPACE, ignore_errors=True)
    return summary, rows


ORBAX_SAVE_WORKSPACE = os.path.join("chiprun_out", "smoke_orbax_save")
ORBAX_SAVE_ROUNDS = 5         # .orbax and .pth saves, alternating, of one state
ORBAX_SAVE_EPOCH = 10         # a ring name the prune spares (*0): no deletes timed


def _disk_bytes(path):
    """A file's bytes, or every file's under a directory."""
    if not os.path.isdir(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def run_flagship_orbax(ckpt_path):
    """Phase 4e: ``--ckpt_format orbax`` at the flagship's width, from the
    main path's checkpoint (its grid warm).  (a) One graphed dispatch of
    GRAPH_K steps, then ORBAX_SAVE_ROUNDS rounds of ``save_checkpoint``
    under ``--ckpt_format orbax`` and under ``pth`` (both through the
    saver, asynchronous), each taking its own snapshot of that state, after
    one save that allocates the saver's pinned buffers: the ms a save
    blocks the training thread, the write's wall (to the end of
    ``wait()``), bytes and MB/s; the median ``.orbax`` block within twice
    the ``.pth`` one.  (b) The directory read back by the port equals the
    state at the save bit for bit: parameters, occupancy, Adam moments and
    count.  (c) A fresh trainer resumed by ``--ckpt latest`` holds the
    saver's Adam state bit for bit; with the saver's generator state (no
    checkpoint holds it) both take the next dispatch of GRAPH_K steps,
    within :func:`dispatch_check`'s bounds of each other (losses, max and
    RMS distance in lr_g a step); the resumed trainer's launches are
    counted on that dispatch and K1-bf16 and dT-bf16 held against their
    plain versions on its inputs.  (d) ``--editing_from`` the directory
    renders the pt image of the ``.pth`` of the same state bit for bit.
    Returns (summary, rows)."""
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import checkpoint as ckpt_io
    from customnerf_torch.engine import editing as ed
    from customnerf_torch.engine.convert import params_from_flax
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.models import field
    from customnerf_torch.models.field import param_names
    from customnerf_torch.ops import triplane

    shutil.rmtree(ORBAX_SAVE_WORKSPACE, ignore_errors=True)
    os.makedirs(os.path.join(ORBAX_SAVE_WORKSPACE, "pth"))
    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + [
        "--workspace", os.path.join(ORBAX_SAVE_WORKSPACE, "ring"), "--ckpt_format", "orbax"])
    a = Trainer(opt, use_checkpoint=ckpt_path, log=lambda *_: None)
    assert a.steps_per_dispatch() == GRAPH_K and a.n_updates > 0
    train = NeRFDataset(opt, "train", device=a.device).dataloader()
    batches = [train.item(i % len(train)) for i in range(2 * GRAPH_K)]
    a.train_many(batches[:GRAPH_K])
    a.global_step += GRAPH_K
    torch.cuda.synchronize()
    # (a) the state at the save, and the saves' times
    want = {k: v.detach().cpu().clone() for k, v in a.field.state_dict().items()}
    order = [p for g in a.optimizer.param_groups for p in g["params"]]
    adam = {n: {k: v.detach().cpu().clone() for k, v in a.optimizer.state[p].items()}
            for n, p in zip(param_names(a.field), order)}
    occ = a.occ_state
    occ_want = {"density_grid": occ.density_grid.cpu().clone(),
                "density_bitfield": occ.bitfield.cpu().clone(),
                "mean_density": float(occ.mean_density), "iter_density": occ.iter_density}
    pth_dir = os.path.join(ORBAX_SAVE_WORKSPACE, "pth")

    def timed(save):
        a._host_cache = None            # each save takes its own snapshot
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save()
        block = (time.perf_counter() - t0) * 1e3
        a.wait_for_saves()
        wall = (time.perf_counter() - t0) * 1e3
        nbytes = _disk_bytes(path)
        return path, {"block_ms": block, "wall_ms": wall, "bytes": nbytes,
                      "mb_per_s": nbytes / 1e6 / (wall / 1e3)}

    a.epoch = ORBAX_SAVE_EPOCH
    _, warm = timed(a.save_checkpoint)
    saves = {"orbax": [], "pth": []}
    for _ in range(ORBAX_SAVE_ROUNDS):
        for fmt in saves:
            a.opt.ckpt_format = fmt
            saves[fmt].append(timed(a.save_checkpoint)[1])
    a.opt.ckpt_format = "orbax"
    stem = os.path.join(a.ckpt_path, f"df_ep{ORBAX_SAVE_EPOCH:04d}")
    assert sorted(os.listdir(a.ckpt_path)) == [os.path.basename(stem) + ".orbax",
                                               os.path.basename(stem) + ".pth"]
    path, pth = stem + ".orbax", os.path.join(pth_dir, os.path.basename(stem) + ".pth")
    os.replace(stem + ".pth", pth)          # out of the ring: --ckpt latest takes the .orbax
    med = {f: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for f, rs in saves.items()}
    assert med["orbax"]["block_ms"] <= 2.0 * med["pth"]["block_ms"], med
    # (b) the port's read of the directory
    params, meta = ckpt_io.load_checkpoint(path, layout=a.optax_layout())
    got = params_from_flax(params)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    for k in ("density_grid", "density_bitfield"):
        assert torch.equal(torch.from_numpy(meta[k]), occ_want[k]), k
    assert (float(meta["mean_density"]), int(meta["iter_density"])) == (
        occ_want["mean_density"], occ_want["iter_density"])
    optim = meta[ckpt_io.TORCH_OPTIMIZER_KEY]
    assert optim["n_updates"] == a.n_updates
    for n, st in adam.items():
        assert float(st["step"]) == float(optim["adam"]["step"]) == a.n_updates, n
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(optim["adam"][k][n], st[k]), (n, k)
    # (c) a fresh trainer resumed by --ckpt latest, and the next dispatch on both
    lines = []
    b = Trainer(opt, use_checkpoint="latest", log=lines.append)
    assert any(path in l for l in lines) and "[INFO] loaded optimizer." in lines, lines
    assert (b.n_updates, b.global_step, b.epoch) == (a.n_updates, a.global_step, a.epoch)
    for pa, pb in zip(order, [p for g in b.optimizer.param_groups for p in g["params"]]):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    b.generator.set_state(a.generator.get_state())
    zero_counts()
    with captured_calls(field, "fused_field_mlp", keep=1,
                        when=lambda a_, k: torch.is_grad_enabled()) as mlp, \
            captured_calls(triplane, "plane_dtable", keep=6) as dt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lb = b.train_many(batches[GRAPH_K:])[0]
        torch.cuda.synchronize()
        resumed_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(graphed=True)
    check_launched(launches, (K1_BF16, DT_BF16), "flagship .orbax resume")
    la = a.train_many(batches[GRAPH_K:])[0]
    loss_rel = float(((la - lb).abs() / la.abs()).max())
    dist = []
    for (pname, p), q in zip(a.field.named_parameters(), b.field.parameters()):
        lr_steps = opt.lr * (10.0 if pname == "grid_table" else 1.0) * GRAPH_K
        d = (p.detach() - q.detach()).float()
        dist.append({"name": pname, "max_over_lr_steps": float(d.abs().max()) / lr_steps,
                     "rms_over_lr_steps": float(d.pow(2).mean().sqrt()) / lr_steps})
    assert loss_rel <= LOSS_RTOL["reconstruction"], (loss_rel, la, lb)
    assert all(q["max_over_lr_steps"] <= 2.0 and q["rms_over_lr_steps"] <= PARAM_RMS_LR
               for q in dist), dist
    summary = {"saves": saves, "median": med, "warm_pth": warm,
               "n_updates": a.n_updates, "loss_rel": loss_rel, "params": dist,
               "resumed_dispatch_ms": resumed_ms, "graph_launches": launches,
               "path": "flagship .orbax resume (graph)"}
    rows = dispatch_rows(mlp[-1], list(dt), summary)
    # (d) --editing_from the directory against the .pth of the same state
    pts = []
    for source in (path, pth):
        eopt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + [
            "--workspace", os.path.join(ORBAX_SAVE_WORKSPACE, "edit_" + os.path.basename(source)),
            "--pretrained", "--editing_from", source])
        etr = Trainer(eopt, use_checkpoint="scratch", log=lambda *_: None)
        pts.append(ed._get_pt(etr, NeRFDataset(eopt, "train", device=etr.device)
                              .dataloader().item(0), torch.ones(3, device=etr.device)))
        del etr
    for k in ("pt_rgb_bg", "pt_rgb_fg", "pt_mask", "pt_depth_fg"):
        assert torch.isfinite(pts[0][k]).all() and torch.equal(pts[0][k], pts[1][k]), k
    summary["pt_image_hw"] = list(pts[0]["pt_rgb_fg"].shape[:2])
    return summary, rows


def log_orbax(card, ob):
    """Phase 4e's lines."""
    for fmt, label in (("orbax", ".orbax directory"), ("pth", ".pth file")):
        rs, m = ob["saves"][fmt], ob["median"][fmt]
        log(f"[orbax save] {card} | flagship, async {label}: {m['bytes'] / 1e6:.1f} MB | "
            f"blocks the training thread {[round(r['block_ms'], 2) for r in rs]} ms "
            f"(median {m['block_ms']:.2f}) | write wall {[round(r['wall_ms'], 1) for r in rs]} "
            f"ms (median {m['wall_ms']:.1f}, {m['mb_per_s']:.0f} MB/s)")
    worst = max(ob["params"], key=lambda q: q["rms_over_lr_steps"])
    log(f"[orbax save] read back bit for bit (parameters, occupancy, Adam moments, count "
        f"{ob['n_updates']}) | --ckpt latest: Adam bit for bit; the next {GRAPH_K}-step "
        f"dispatch {ob['resumed_dispatch_ms']:.1f} ms with its capture, against the saver's: "
        f"losses within {ob['loss_rel']:.2g} rel, params max "
        f"{max(q['max_over_lr_steps'] for q in ob['params']):.3g} lr_g-steps, RMS "
        f"{worst['rms_over_lr_steps']:.3g} ({worst['name']}) | launches "
        f"{ob['graph_launches']} | --editing_from pt image {ob['pt_image_hw']} equal to "
        f"the .pth's")


def run_f32_dtable_steps(trainer):
    """DT_F32_STEPS more steps of the main path's trainer with its tri-plane
    spec's ``mm_bf16`` off (the JAX package's f32 table gradient, the
    setting of its f32 parity tests): counters zeroed before and read
    after, dT's f32 mode must launch and its bf16 mode must not.  Returns
    the summary and the last step's dT calls."""
    import dataclasses
    import torch
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.ops import triplane

    train = NeRFDataset(trainer.opt, "train", device=trainer.device).dataloader()
    cfg = trainer.field.cfg
    trainer.field.cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, mm_bf16=False))
    try:
        with captured_calls(triplane, "plane_dtable", keep=6) as dt_calls:
            zero_counts()
            losses = []
            for _ in range(DT_F32_STEPS):
                trainer.global_step += 1
                losses.append(float(trainer.train_step(train.item(0))[0]))
            torch.cuda.synchronize()
            launches = read_counts()
    finally:
        trainer.field.cfg = cfg
    check_launched(launches, (K1, DT), "f32 table gradient")
    assert all(math.isfinite(v) for v in losses), losses
    return {"steps": DT_F32_STEPS, "losses": losses, "launches": launches}, list(dt_calls)


# ------------------------------------------------------ K steps a dispatch
GRAPH_K = 8                   # --steps_per_dispatch's value on the card
FLAGSHIP_DISPATCHES = 3
PARITY_DISPATCHES = 2
EDIT_DISPATCHES = 1
# graphed against eager steps from one saved state: the same draws and
# kernels; they differ by the order of the card's atomic sums (dT,
# index_add_), which Adam's ±lr steps turn into sign flips where a gradient
# is near zero, and (editing) by the SD stack's bf16 roundings of the
# render that follows, amplified by cfg 100
LOSS_RTOL = {"reconstruction": 1e-2, "editing": 5e-2}
# a parameter tensor's RMS distance from the eager run's, in lr_g a step:
# within PARAM_RMS_LR, and within SPREAD_RATIO times the card's own spread
# (the larger distance of a second eager run and of an eager run on a side
# stream) or SPREAD_FLOOR, whichever is larger.  Read on an H100: ratios up
# to 1.5 (the flagship's grid table), the editing paths' distances 1e-5 to
# 1e-4 (under the floor), and on every path the side-stream run as close as
# the second eager run: the stream does not move the sums
PARAM_RMS_LR = 1e-2
SPREAD_RATIO = 8.0
SPREAD_FLOOR = 1e-4


def _timed_capture():
    """Patch the trainer's StepGraph to time each capture (warm-up steps
    included); returns the list the times go to and the undo function."""
    import torch
    from customnerf_torch.engine import trainer as trainer_mod
    base, times = trainer_mod.StepGraph, []

    class Timed(base):
        def __init__(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().__init__(*a, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

    trainer_mod.StepGraph = Timed
    return times, lambda: setattr(trainer_mod, "StepGraph", base)


def dispatch_check(tr, batches, kind, path):
    """From one saved state (parameters, Adam state, update counter,
    generator, LGIE stream), ``len(batches)`` steps five times: eager, eager
    again, eager on a side stream, in dispatches of GRAPH_K (one captured
    step replayed), and in dispatches again (replays only).  The first
    graphed run against the first eager one: per-step losses within
    LOSS_RTOL, every parameter within 2·lr_g a step, its RMS distance within
    PARAM_RMS_LR·lr_g a step and within SPREAD_RATIO times the distance of
    the second or the side-stream eager run (or SPREAD_FLOOR; the second
    graphed run's distance from the first is recorded), each kernel mode launched, as
    the kernels counted on the card, (steps + warm-up steps)/steps times as
    often as eager (the wrappers counting the warm-up steps only), and the
    replays-only run exactly as often.  The summary holds the median ms a
    step of both, the capture's ms, peaks and the tracer's split of one
    graphed dispatch (``engine/step_profile.py::graphed_split``: each device
    span in ms a step).  Returns (summary, K1's and dT's inputs as the graph
    holds them)."""
    import contextlib
    import torch
    from customnerf_torch.engine import editing as ed
    from customnerf_torch.engine.dispatch import WARMUP_STEPS, SavedState
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.step_profile import graphed_split
    from customnerf_torch.models import field
    from customnerf_torch.ops import triplane

    editing = kind == "editing"
    n = len(batches)
    if editing:                     # every view's pt entry before the state is saved
        for b in batches:
            ed._get_pt(tr, b, ed._bg_color(tr))
    saved = SavedState([*tr.field.parameters(), tr._count_t], tr.optimizer.state,
                       tr.generator)
    host = (tr.n_updates, tr.global_step, tr.np_rng.get_state())

    def restore():
        saved.restore()
        tr.n_updates, tr.global_step = host[:2]
        tr.np_rng.set_state(host[2])

    def run(graphed, stream=None):
        """One run from the saved state: per-call ms, losses, the kernels'
        and the wrappers' launch counts, the peak, parameters and moments."""
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            for i in range(0, n, GRAPH_K if graphed else 1):
                t0 = time.perf_counter()
                if not graphed:
                    tr.global_step += 1
                    losses.append(tr.train_step(batches[i])[0])
                elif editing:
                    losses += list(ed.editing_steps_many(tr, batches[i:i + GRAPH_K])[0])
                else:
                    group = batches[i:i + GRAPH_K]
                    losses += list(tr.train_many(group)[0])
                    tr.global_step += len(group)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        out = {"ms": ms, "losses": torch.stack(losses),
               "launches": read_counts(graphed=graphed),
               "wrapper_launches": read_wrapper_counts(),
               "peak": torch.cuda.max_memory_allocated(),
               "params": [p.detach().clone() for p in tr.field.parameters()],
               "moments": [v.detach().clone() for st in tr.optimizer.state.values()
                           for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]}
        restore()
        return out

    eager = run(False)
    spread = {"eager_again": run(False), "eager_side_stream": run(False, torch.cuda.Stream())}
    for r in spread.values():
        del r["moments"]
    captures, undo = _timed_capture()
    try:
        with captured_calls(field, "fused_field_mlp", keep=1,
                            when=lambda a, k: torch.is_grad_enabled()) as mlp, \
                captured_calls(triplane, "plane_dtable", keep=6) as dt:
            graph = run(True)
        spread["graph_again"] = run(True)
    finally:
        undo()
    assert len(captures) == 1, captures
    eager_counts, graph_counts = eager["launches"], graph["launches"]
    for name, e in eager_counts.items():
        assert graph_counts[name] * n == e * (n + WARMUP_STEPS), (path, name, eager_counts, graph)
        assert graph["wrapper_launches"][name] * n == e * WARMUP_STEPS, (path, name, graph)
        assert spread["graph_again"]["launches"][name] == e, (path, name, spread)
        assert spread["graph_again"]["wrapper_launches"][name] == 0, (path, name, spread)
    steady = [ms / len(batches[i * GRAPH_K:(i + 1) * GRAPH_K]) for i, ms in enumerate(graph["ms"])]
    steady[0] = (graph["ms"][0] - captures[0]) / min(GRAPH_K, n)
    a, b = eager["losses"], graph["losses"]
    loss_rel = float(((a - b).abs() / a.abs()).max())
    lr = tr.opt.lr
    params = []
    for i, (pname, p) in enumerate(tr.field.named_parameters()):
        lr_steps = lr * (10.0 if pname == "grid_table" else 1.0) * n
        e = eager["params"][i]

        def rms(x, y=e):
            return float((x - y).pow(2).mean().sqrt()) / lr_steps

        q = {"name": pname, "lr_g": lr_steps / n,
             "max_over_lr_steps": float((graph["params"][i] - e).abs().max()) / lr_steps,
             "rms_over_lr_steps": rms(graph["params"][i]),
             "eager_again_rms_over_lr_steps": rms(spread["eager_again"]["params"][i]),
             "eager_side_stream_rms_over_lr_steps":
                 rms(spread["eager_side_stream"]["params"][i]),
             "graph_again_rms_over_lr_steps":       # from the first graphed run
                 rms(spread["graph_again"]["params"][i], graph["params"][i])}
        q["spread_ratio"] = q["rms_over_lr_steps"] / max(
            SPREAD_FLOOR, q["eager_again_rms_over_lr_steps"],
            q["eager_side_stream_rms_over_lr_steps"])
        params.append(q)
    mom_rel = max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                  for x, y in zip(graph["moments"], eager["moments"]))
    worst = max(params, key=lambda q: q["spread_ratio"])
    log(f"[dispatch {path}] RMS distance from the eager run, in lr_g·steps, of "
        f"{worst['name']} (the largest spread ratio): graphed "
        f"{worst['rms_over_lr_steps']:.3g}, eager again "
        f"{worst['eager_again_rms_over_lr_steps']:.3g}, eager on a side stream "
        f"{worst['eager_side_stream_rms_over_lr_steps']:.3g} (ratio "
        f"{worst['spread_ratio']:.3g}); graphed again from graphed "
        f"{worst['graph_again_rms_over_lr_steps']:.3g}; ratios: "
        + ", ".join(f"{q['name']} {q['spread_ratio']:.3g}" for q in params))
    assert loss_rel <= LOSS_RTOL[kind], (path, loss_rel, a, b)
    assert all(q["max_over_lr_steps"] <= 2.0 for q in params), (path, params)
    assert all(q["rms_over_lr_steps"] <= PARAM_RMS_LR for q in params), (path, params)
    assert all(q["spread_ratio"] <= SPREAD_RATIO for q in params), (path, params)
    assert all(math.isfinite(v) for v in b.tolist())
    split = graphed_split(tr, batches[:GRAPH_K])
    step_span = "edit.step" if editing else "recon.step"
    summary = {
        "path": path, "steps": n, "k": GRAPH_K, "eager_ms": eager["ms"],
        "graph_ms": graph["ms"], "capture_ms": captures[0],
        "median_eager_ms": statistics.median(eager["ms"]),
        "median_graph_ms": statistics.median(steady),
        "eager_peak_gb": eager["peak"] / 1e9, "graph_peak_gb": graph["peak"] / 1e9,
        "eager_launches": eager_counts, "graph_launches": graph_counts,
        "graph_wrapper_launches": graph["wrapper_launches"],
        "replay_only_launches": spread["graph_again"]["launches"],
        "loss_max_rel": loss_rel, "moments_max_rel": mom_rel, "params": params,
        "eager_losses": a.tolist(), "graph_losses": b.tolist(),
        "split": split, "step_span_ms": split["spans"][step_span]["ms"]}
    log(f"[dispatch {path}] {n} steps eager vs {n // GRAPH_K} dispatches of K = "
        f"{GRAPH_K}: median {summary['median_eager_ms']:.2f} vs "
        f"{summary['median_graph_ms']:.2f} ms/step (capture with {WARMUP_STEPS} "
        f"warm-up steps {captures[0]:.0f} ms) | graphed {step_span} span "
        f"{summary['step_span_ms']:.2f} ms | peak {summary['eager_peak_gb']:.2f} vs "
        f"{summary['graph_peak_gb']:.2f} GB | losses within {loss_rel:.2g} rel, "
        f"moments {mom_rel:.2g} rel, params max {max(q['max_over_lr_steps'] for q in params):.3g}"
        f" lr·steps, RMS {max(q['rms_over_lr_steps'] for q in params):.3g} lr·steps | "
        f"launches counted on the card {graph_counts} (wrappers: "
        f"{graph['wrapper_launches']}; replays only {spread['graph_again']['launches']})")
    return summary, mlp[-1], list(dt)


def dispatch_rows(mlp, dt, summary, with_dt=True):
    """K1 (and dT) held against their plain versions on the inputs the
    captured step holds after the last replay."""
    rows = [check_fused_mlp(*mlp[0], **mlp[1])]
    if with_dt:
        rows += dtable_rows(dt)
    for r in rows:
        r["launches"] = summary["graph_launches"][r["name"]]
        r["path"] = summary["path"]
    return rows


def checkpoint_blocking(tr, batches, label):
    """The time a save blocks the training thread, synchronous against
    ``AsyncSaver`` (twice: its first save allocates the pinned buffers);
    an asynchronous file written while a dispatch went on reloads bit for
    bit as the state at the save; a write that cannot land raises at
    ``wait()``.  Deletes its files."""
    import torch
    from customnerf_torch.engine import checkpoint as ckpt_io
    from customnerf_torch.engine.convert import params_from_flax

    def steps():
        tr.train_many(batches)
        tr.global_step += len(batches)

    def blocked(saver):
        # after steps: a new state, whose snapshot the save takes
        tr.saver = saver
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.epoch += 1
        path = tr.save_checkpoint()
        return path, (time.perf_counter() - t0) * 1e3

    steps()
    sync_path, sync_ms = blocked(None)
    nbytes = os.path.getsize(sync_path)
    saver = ckpt_io.AsyncSaver()
    steps()
    _, first_ms = blocked(saver)
    tr.wait_for_saves()
    steps()
    want = {k: v.detach().cpu().clone() for k, v in tr.field.state_dict().items()}
    adam = [v.detach().cpu().clone() for s in tr.optimizer.state.values()
            for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
    path, async_ms = blocked(saver)
    t0 = time.perf_counter()
    tr.train_many(batches)              # steps go on while the worker writes
    tr.global_step += len(batches)
    torch.cuda.synchronize()
    steps_ms = (time.perf_counter() - t0) * 1e3
    pending = saver.pending
    t0 = time.perf_counter()
    tr.wait_for_saves()
    wait_ms = (time.perf_counter() - t0) * 1e3
    params, meta = ckpt_io.load_checkpoint(path)
    got = params_from_flax(params)
    assert all(torch.equal(got[k], want[k]) for k in want), "async file differs"
    state = meta[ckpt_io.TORCH_OPTIMIZER_KEY]["state_dict"]["state"]
    saved = [state[i][k] for i in sorted(state) for k in ("exp_avg", "exp_avg_sq")]
    assert all(torch.equal(x, y) for x, y in zip(saved, adam)), "async Adam state differs"
    assert not torch.equal(tr.field.grid_table.detach().cpu(), want["grid_table"])
    # a directory that cannot be created: the worker fails, wait() raises
    good = tr.ckpt_path
    blocker = os.path.join(good, "not_a_directory")
    with open(blocker, "w"):
        pass
    tr.ckpt_path = os.path.join(blocker, "checkpoints")
    tr.save_checkpoint()
    try:
        tr.wait_for_saves()
        raise AssertionError("a failed write passed silently")
    except OSError as e:
        failed = f"{type(e).__name__}: {e}"
    tr.ckpt_path, tr.saver = good, None
    shutil.rmtree(good, ignore_errors=True)
    out = {"bytes": nbytes, "sync_block_ms": sync_ms, "async_first_block_ms": first_ms,
           "async_block_ms": async_ms, "steps_during_write_ms": steps_ms,
           "pending_after_steps": pending, "wait_ms": wait_ms, "bitwise": True,
           "failed_write": failed}
    log(f"[checkpoint {label}] {nbytes} bytes: a save blocks the training thread "
        f"{sync_ms:.1f} ms synchronously, {first_ms:.1f} ms asynchronously at the first "
        f"save (pinned buffers) and {async_ms:.1f} ms after; {len(batches)} steps "
        f"({steps_ms:.1f} ms) ran during the write (still pending: {pending}), then "
        f"waited {wait_ms:.1f} ms; reloads bit for bit; a failed write raised at "
        f"wait(): {failed[:80]}")
    return out


# ----------------------------------------------------------------- kernels
def check_fused_mlp(x, v, ws, with_rgb=True, bf16=False):
    """K1 in the mode the path ran (``bf16``) against its plain version on
    the inputs the path gave it (f32 cuBLAS with TF32 off, or the bf16
    head's cuBLAS bf16 GEMMs), with the other mode's kernel time on the same
    inputs beside it."""
    import torch
    from customnerf_torch.engine.measure import device_ms
    from customnerf_torch.ops import fused_mlp as fm

    B, in_dim = x.shape
    dir_dim, hid, n_out = ws[5].shape[0] - ws[1].shape[0], ws[0].shape[1], ws[6].shape[1]
    dtype = torch.bfloat16 if bf16 else torch.float32
    sig_k, rgb_k = fm.fused_mlp_forward(x, v, ws, with_rgb, bf16)
    sig_p, rgb_p = fm.reference_forward(x, v, ws, with_rgb, dtype)
    torch.cuda.synchronize()
    outs = [(sig_k, sig_p)] + ([(rgb_k, rgb_p)] if with_rgb else [])
    err = max(float((k - p).abs().max()) for k, p in outs)
    scale = max(float(p.abs().max()) for _, p in outs)
    if bf16:
        # the same bf16 roundings; each layer sums in another order than
        # cuBLAS, so a sum near a rounding boundary lands one ulp apart and
        # carries on: 1e-2 of the largest output, about 2.5 bf16 ulps
        tol = 1e-2 * max(scale, 1e-6)
    else:
        # split-TF32 (three TF32 products, each operand's dropped part ≤
        # 2^-22 of it) against f32 with another summation order over ≤
        # 91-term dots in 3-5 layers: well under 1e-4 of the largest output;
        # a wrong index or a missed tile gives errors of order one
        tol = 1e-4 * max(scale, 1.0)
    if not (err <= tol and all(bool(torch.isfinite(k).all()) for k, _ in outs)):
        raise AssertionError(f"fused_mlp bf16={bf16} B={B}: max_abs_err {err} > tol {tol}")
    sigma_bitwise = None
    if not with_rgb:
        # sigma of the density-only head is the full head's, bit for bit
        zeros = torch.zeros(B, dir_dim, device=x.device)
        sigma_bitwise = bool(torch.equal(fm.fused_mlp_forward(x, zeros, ws, True, bf16)[0],
                                         sig_k))
        if not sigma_bitwise:
            raise AssertionError("density-only sigma differs from the full call's")
    reps = 20 if B < 10 ** 6 else 5
    k_ms = device_ms(lambda: fm.fused_mlp_forward(x, v, ws, with_rgb, bf16), reps)
    call_ms = device_ms(lambda: fm.fused_mlp_forward(x, v, ws, with_rgb, bf16), reps,
                        host_ahead=False)
    p_ms = device_ms(lambda: fm.reference_forward(x, v, ws, with_rgb, dtype), reps)
    other_ms = device_ms(lambda: fm.fused_mlp_forward(x, v, ws, with_rgb, not bf16), reps)
    used = ws if with_rgb else ws[:5]
    macs = sum(w.shape[0] * w.shape[1] for w in used)
    nbytes = (B * (in_dim + 1 + (dir_dim + n_out if with_rgb else 0)) * 4
              + macs * 4)
    if bf16:
        b_ms, b_by = bound(2.0 * macs * B, nbytes, PEAK_BF16_FLOPS)
        peak = "one pass at the dense bf16 tensor rate 989 TFLOP/s; HBM3 3.35 TB/s"
    else:
        b_ms, b_by = bound(TF32_PASSES * 2.0 * macs * B, nbytes, PEAK_TF32_FLOPS)
        peak = "3 passes at the dense TF32 tensor rate 495 TFLOP/s; HBM3 3.35 TB/s"
    f32_ms, _ = bound(2.0 * macs * B, nbytes)
    return {"name": K1_BF16 if bf16 else K1,
            "shape": f"B={B} in={in_dim} dir={dir_dim} hidden={hid} out={n_out}"
                     + ("" if with_rgb else " density-only"),
            "route": "cuda", "source": "customnerf_torch/csrc/fused_mlp.cu",
            "replaces": "customnerf_tpu/ops/fused_mlp_pallas.py:59",
            "max_abs_err": err, "tolerance": tol, "ms": k_ms, "kernel_ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_peak": peak,
            "bound_f32_fma_ms": f32_ms, "library_ms": None,
            "other_mode_ms": other_ms, "sigma_bitwise": sigma_bitwise}


def check_dtable(u0, v0, fu, fv, g, R: int, C: int, bf16: bool = False):
    """dT in the mode the path ran (``bf16``) against its plain version
    (index_add_ of the same, rounded, corner contributions) and a single
    index_add_ call (the library yardstick), on one plane of a step."""
    import torch
    from customnerf_torch.engine.measure import device_ms
    from customnerf_torch.ops import triplane_kernels as tk

    B = u0.shape[0]
    got = tk.plane_dtable(u0, v0, fu, fv, g, R, C, bf16=bf16)
    want = tk.plane_dtable_reference(u0, v0, fu, fv, g, R, C, bf16=bf16)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # both sum in an order set by atomics (the same bf16 roundings in the
    # bf16 mode); a texel takes up to a few thousand terms: a few ulp of the
    # largest texel sum
    tol = 1e-5 * max(float(want.abs().max()), 1e-6)
    if not err <= tol:
        raise AssertionError(f"plane_dtable bf16={bf16} R={R} C={C}: max_abs_err "
                             f"{err} > tol {tol}")
    # into a zeroed block, as the main path calls it (the step zero-fills
    # the whole table gradient once)
    into = torch.zeros(R * R, C, device=g.device)
    k_ms = device_ms(lambda: tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=into,
                                             bf16=bf16), 20)
    call_ms = device_ms(lambda: tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=into,
                                                bf16=bf16), 20, host_ahead=False)
    p_ms = device_ms(lambda: tk.plane_dtable_reference(u0, v0, fu, fv, g, R, C,
                                                       out=into, bf16=bf16), 20)
    other_ms = device_ms(lambda: tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=into,
                                                 bf16=not bf16), 20)
    rows, vals = tk.corner_values(u0, v0, fu, fv, g, R, C, bf16)
    rows, vals = rows.reshape(-1), vals.reshape(-1, C)
    out = torch.zeros(R * R, C, device=g.device)
    lib_ms = device_ms(lambda: out.index_add_(0, rows, vals), 20)
    # samples whose cotangent is all zero (dead compaction slots) add
    # nothing: time the kernel on the others alone
    live = (g != 0).any(dim=1)
    n_live = int(live.sum())
    sel = [t[live].contiguous() for t in (u0, v0, fu, fv, g)]
    live_ms = device_ms(lambda: tk.plane_dtable(*sel, R, C, out=into, bf16=bf16), 20)
    # every g is read (to find the zeros); corners and fractions of the live
    # samples; the plane written once
    nbytes = B * 4 * C + n_live * 16 + R * R * C * 4
    b_ms, b_by = bound(8.0 * C * n_live, nbytes)
    return {"name": DT_BF16 if bf16 else DT, "shape": f"R={R} C={C} B={B}",
            "route": "cuda", "source": "customnerf_torch/csrc/triplane_dtable.cu",
            "replaces": "customnerf_tpu/ops/triplane_pallas.py:57, "
                        "customnerf_tpu/ops/triplane_pallas.py:166",
            "max_abs_err": err, "tolerance": tol, "ms": k_ms, "kernel_ms": k_ms,
            "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_peak": "HBM3 3.35 TB/s; f32 67 TFLOP/s",
            "library_ms": lib_ms, "live_share": n_live / B,
            "live_rows_ms": live_ms, "other_mode_ms": other_ms}


def log_row(r):
    log(f"[kernel] {r['path']} {r['name']} {r['shape']}: err {r['max_abs_err']:.3g} "
        f"(tol {r['tolerance']:.3g}) kernel {r['ms']:.4f} ms"
        + (f" (the other mode {r['other_mode_ms']:.4f} ms)"
           if r["other_mode_ms"] is not None else "")
        + f" plain {r['plain_ms']:.4f} ms (a wrapper call with the host in the loop "
        f"{r['call_ms']:.4f} ms) bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
        + (f" library {r['library_ms']:.4f} ms" if r["library_ms"] else "")
        + (f" | live rows {r['live_share']:.3f}: {r['live_rows_ms']:.4f} ms"
           if "live_rows_ms" in r else
           f" | f32-FMA bound {r['bound_f32_fma_ms']:.4f} ms"
           if "bound_f32_fma_ms" in r else "")
        + (f" | launches {r['launches']}" if "launches" in r else ""))


def dtable_rows(calls):
    """dT against its plain version on the XY plane of each level of a
    step's captured calls ((level 0: XY, XZ, YZ), (level 1: ...))."""
    return [check_dtable(*calls[i][0][:7], bf16=calls[i][1].get("bf16", False))
            for i in (0, 3)]


# ----------------------------------------------------------------- editing
def _equal_renders(a, b) -> bool:
    import torch
    return all(torch.equal(a[k], b[k]) for k in ("image", "depth", "weights_sum",
                                                  "render_mask")) and \
        all(torch.equal(a[s][k], b[s][k]) for s in ("fg", "bg") for k in a[s])


def run_checkpoint(recon):
    """Phase 4: save, build the editing trainer from the file (the default
    policy: bf16 heads), check that its frozen field holds the saved
    parameters bit for bit and, in the saving trainer's f32 head, renders
    the validation view bit for bit as the saving trainer.  Returns
    (editing trainer, its options, summary)."""
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer, build_field
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
    frozen = trainer.field_pretrained
    assert frozen.fused_bf16 and not recon.field.fused_bf16
    assert all(torch.equal(a, b) for a, b in zip(frozen.state_dict().values(),
                                                  recon.field.state_dict().values()))
    view = NeRFDataset(opt, "val", device=trainer.device).dataloader().item(0)
    saved = recon.render_image(view.rays_o, view.rays_d, perturb=False)
    as_saved = build_field(recon.opt, trainer.device)
    as_saved.load_state_dict(frozen.state_dict())
    loaded = trainer.render_image(view.rays_o, view.rays_d, perturb=False,
                                  field=as_saved)
    assert _equal_renders(saved, loaded), "the reloaded field renders differently"
    del as_saved
    return trainer, opt, {"checkpoint": os.path.relpath(path),
                          "bytes": os.path.getsize(path), "bitwise": True}


def sd_bounds(guidance):
    """The least time the card could take for the SD parts of an editing
    step, from FLOPs counted by ``torch.utils.flop_counter`` on the meta
    device (matmuls and convolutions; elementwise work is not counted) at
    the peak of the stack's dtype (bf16 on the card), and the bytes of each
    part's weights (in that dtype) and f32 inputs/outputs at the HBM peak:
    the UNet's forward on [2, 4, 64, 64], and the VAE encoder's forward and
    its backward to the image at 512², with the UNet's own context width."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from customnerf_torch.guidance.layers import build, n_params
    from customnerf_torch.guidance.unet import UNet2DCondition
    from customnerf_torch.guidance.vae import AutoencoderKL

    meta = torch.device("meta")
    unet = build(UNet2DCondition, guidance.unet.cfg, device=meta).requires_grad_(False)
    vae = build(AutoencoderKL, guidance.vae.cfg, device=meta).requires_grad_(False)
    lat = torch.empty(2, 4, 64, 64, device=meta)
    ctx = unet.cfg.cross_attention_dim          # 768 for SD 1.5, 1024 for 2.x
    with FlopCounterMode(display=False) as fc:
        unet(lat, torch.zeros(2, dtype=torch.long, device=meta),
             torch.empty(2, 77, ctx, device=meta))
    unet_flops = fc.get_total_flops()
    img = torch.empty(1, 3, 512, 512, device=meta, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        z = vae.encode(img, noise=torch.empty(1, 4, 64, 64, device=meta))
    enc_flops = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        z.sum().backward()
    bwd_flops = fc.get_total_flops()
    w = guidance.unet.conv_in.weight.element_size()
    peak = PEAK_BF16_FLOPS if w == 2 else PEAK_F32_FLOPS
    enc_bytes = (w * (n_params(vae.encoder) + n_params(vae.quant_conv))
                 + 4 * (img.numel() + 2 * z.numel()))
    unet_bytes = w * n_params(unet) + 4 * (2 * 2 * lat.numel() + 2 * 77 * ctx)
    out = {}
    for name, flops, nbytes in (("unet_forward", unet_flops, unet_bytes),
                                ("vae_encoder_forward", enc_flops, enc_bytes),
                                ("vae_encoder_backward", bwd_flops, 2 * enc_bytes)):
        ms, by = bound(flops, nbytes, peak)
        out[name] = {"flops": flops, "bytes": nbytes, "bound_ms": ms, "bound_by": by,
                     "peak_flops": peak}
    return out


def traced(fn):
    """``fn()`` with the tracer on (``customnerf_torch/engine/spans.py``):
    (its result, its wall ms to a synchronize, each span's device ms, each
    host span's ms)."""
    import torch
    from customnerf_torch.engine import spans
    spans.enable(True)
    spans.reset()
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = spans.collect()["spans"]
    finally:
        spans.enable(False)
    return (out, wall, {k: v["device_ms"] for k, v in got.items()},
            {k: v["host_ms"] for k, v in got.items()})


def editing_stages(ms, host) -> dict:
    """An eager editing step's stages from the tracer's spans: the pre-pass's
    host ms (a pt render on a miss), then the device spans of ``edit.step``."""
    pt = host.get("pre_pass", 0.0)
    return {"total": pt + ms["edit.step"], "pt_and_draws": pt,
            "render_to_latents": ms["render"] + ms["resize"] + ms["vae_encode"],
            "unet": ms["unet"], "backward_adam": ms["loss"] + ms["backward"] + ms["adam"]}


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
    counters zeroed just before and read just after, with the tracer's stage
    times (:func:`editing_stages`).  Returns (steps, launches, peak and
    resident bytes, the last step's K1 and dT inputs, the field's largest
    change, the train loader)."""
    import torch
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.models import field
    from customnerf_torch.ops import triplane

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
        zero_counts()
        for _ in range(n_steps):
            batch = train.item(0)
            refreshed = (opt.cuda_ray
                         and trainer.global_step % opt.update_extra_interval == 0)
            if refreshed:
                trainer.update_extra_state()
            trainer.global_step += 1
            (loss, aux, stats), _, ms, host = traced(lambda: trainer.train_step(batch))
            span = editing_stages(ms, host)
            mlp_input = mlp_calls[-1]
            steps.append(dict(span, step=trainer.global_step, refreshed=refreshed,
                              loss=float(loss), loss_sds=float(aux["loss_sds"]),
                              loss_bg=float(aux["loss_bg"]),
                              local=bool(stats["local"]), t=int(stats["t"]),
                              pt_cached=len(trainer.pt_dict)))
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(s[k]) for s in steps
               for k in ("loss", "loss_sds", "loss_bg")), steps
    assert all(e["match_probs"] is not None for e in trainer.pt_dict.values()), \
        "clip_view prompt selection did not run"
    moved = [float((p.detach() - b).abs().max())
             for p, b in zip(trainer.field.parameters(), before)]
    assert all(m > 0 for m in moved), f"the field did not change: {moved}"
    return steps, launches, peak, base_mem, mlp_input, list(dt_calls), max(moved), train


def run_editing(trainer, opt, label="editing"):
    """Phases 5-6 (and the SD 2.x phase's text editing): the full-width SD
    stack of ``--sd_version``, then EDIT_STEPS editing steps through
    ``Trainer.train_step``.  Returns its summary and the kernels' inputs of
    the last step."""
    import torch
    from customnerf_torch.engine import editing
    from customnerf_torch.guidance.layers import n_params
    from customnerf_torch.guidance.sds import FULL_WIDTH_PARAMS, sd_family

    guidance = trainer.guidance
    editing.prepare_text_embeddings(trainer)
    counts = dict(guidance.param_counts(),
                  clip_view=n_params(trainer.clip_matcher.model))
    want = FULL_WIDTH_PARAMS[sd_family(opt.sd_version)]
    assert counts == want, (opt.sd_version, counts, want)
    # the JAX package's rule: UNet and VAE stored (and run) in bf16 on the
    # card, the text tower and the CLIP view matcher in f32
    for models, dtype in (((guidance.unet, guidance.vae), torch.bfloat16),
                          ((guidance.text_encoder.model, trainer.clip_matcher.model),
                           torch.float32)):
        assert all(p.dtype == dtype and p.is_cuda for m in models
                   for p in m.parameters()), f"SD stack not {dtype} on the card"

    steps, launches, peak, base_mem, mlp_input, dt_calls, moved, train = editing_steps(
        trainer, opt, EDIT_STEPS)
    check_launched(launches, (K1_BF16, DT_BF16), "editing")
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
        "sd_dtype": guidance.dtype, "sd_init_s": guidance.init_seconds,
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
    summary["dispatch"], summary["dispatch_rows"] = editing_dispatch(
        trainer, train, f"{label} dispatch (graph)")
    return summary, mlp_input, dt_calls


def editing_dispatch(trainer, train, path):
    """(c) EDIT_DISPATCHES × K editing steps: eager against dispatches of
    K = 8 (:func:`dispatch_check`), K1 and dT on the graph's inputs."""
    batches = [train.item(i % len(train)) for i in range(EDIT_DISPATCHES * GRAPH_K)]
    summary, mlp, dt = dispatch_check(trainer, batches, "editing", path)
    check_launched(summary["graph_launches"], (K1_BF16, DT_BF16), path)
    return summary, dispatch_rows(mlp, dt, summary)


# ------------------------------------------------------------- N scenes
SCENE_STEPS = 4
SCENE_PROMPTS = [("a corgi in a forest", "a corgi"), ("a tiger in the snow", "a tiger"),
                 ("a panda on the moon", "a panda"),
                 ("a bronze statue of a bear", "a bronze bear")]
SCENE_LOSS_RTOL = 5e-2            # the editing dispatch check's tolerance


def _scene_state(tr, S, editing):
    """S scenes from the trainer's field and Adam state, each with its own
    copy of the occupancy grid."""
    import torch
    from customnerf_torch.ops.occupancy import OccupancyState
    named = list(tr.field.named_parameters())
    params_s = editing.stack_trees([{n: p.detach().clone() for n, p in named}] * S)
    opt_s = {"step": torch.full((S,), float(tr.n_updates)),
             **{k: {n: torch.stack([tr.optimizer.state[p][k]] * S) for n, p in named}
                for k in ("exp_avg", "exp_avg_sq")}}
    occ = tr.occ_state
    occ_s = editing.stack_trees([OccupancyState(
        occ.density_grid.clone(), occ.bitfield.clone(), occ.mean_density.clone(),
        occ.iter_density, occ.grid_size) for _ in range(S)])
    return params_s, opt_s, occ_s


def run_multi_scene(tr, opt):
    """Phase 7a: S = 2 (and S = 4) scenes a step on the editing trainer.
    Returns its summary and K1 / dT rows on its inputs."""
    import torch
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing as ed
    from customnerf_torch.engine.dispatch import SavedState
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.models import field
    from customnerf_torch.ops import triplane

    dev = tr.device
    train = NeRFDataset(opt, "train", device=dev).dataloader()
    views = [train.item(i % len(train)) for i in range(4)]
    scenes = [ed.prepare_scene_prompts(tr, *p) for p in SCENE_PROMPTS]

    # one eager single-scene step: its launches and stage times
    tr.global_step += 1
    tr.train_step(views[0])                      # its pt entry
    single_ms, single_unet = [], []
    for k in range(3):
        torch.cuda.synchronize()
        if k == 2:
            zero_counts()
        tr.global_step += 1
        _, wall, ms, _ = traced(lambda: tr.train_step(views[0]))
        single_ms.append(wall)
        single_unet.append(ms["unet"])
    single_launches = read_counts()

    # (a) S = 2: a step that fills the pt entries, then SCENE_STEPS counted
    params_s, opt_s, occ_s = _scene_state(tr, 2, ed)
    params_s, opt_s, _, _ = ed.editing_step_scenes(tr, views[:2], params_s, opt_s,
                                                   scenes=scenes[:2], occ_s=occ_s)
    start = {k: v.clone() for k, v in params_s.items()}
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with captured_calls(field, "fused_field_mlp", keep=4) as mlp_calls, \
            captured_calls(triplane, "plane_dtable", keep=6) as dt_calls:
        zero_counts()
        for _ in range(SCENE_STEPS):
            (params_s, opt_s, losses, aux), wall, ms, _ = traced(
                lambda: ed.editing_step_scenes(tr, views[:2], params_s, opt_s,
                                               scenes=scenes[:2], occ_s=occ_s))
            steps.append({"ms": wall, "unet_ms": ms["unet"],
                          "losses": losses.tolist(),
                          "loss_sds": aux["loss_sds"].tolist(),
                          "loss_bg": aux["loss_bg"].tolist()})
        launches = read_counts()
        mlp_input, dt_input = mlp_calls[-1], list(dt_calls)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(v) for s in steps for k in ("losses", "loss_sds", "loss_bg")
               for v in s[k]), steps
    moved = [min(float((params_s[n][i] - start[n][i]).abs().max()) for n in start)
             for i in range(2)]
    assert all(m > 0 for m in moved), f"a scene's field did not move: {moved}"
    for name, n in single_launches.items():
        assert launches[name] == 2 * SCENE_STEPS * n, \
            (f"{name}: {launches[name]} launches in {SCENE_STEPS} S = 2 steps, "
             f"a single-scene step {n}")
    check_launched(launches, (K1_BF16, DT_BF16), "multi-scene editing")

    # (b) S = 4: a step that fills the pt entries, then 2 timed
    p4, o4, occ4 = _scene_state(tr, 4, ed)
    p4, o4, _, _ = ed.editing_step_scenes(tr, views, p4, o4, scenes=scenes, occ_s=occ4)
    s4 = []
    for _ in range(2):
        (p4, o4, losses4, _), wall, ms, _ = traced(
            lambda: ed.editing_step_scenes(tr, views, p4, o4, scenes=scenes, occ_s=occ4))
        s4.append({"ms": wall, "unet_ms": ms["unet"]})
        assert bool(torch.isfinite(losses4).all()), losses4
    del p4, o4, occ4

    # (c) one S = 2 step against two single-scene steps with the same draws
    for i, v in enumerate(views[:2]):
        tr.pt_dict[(i, v.img_path)] = ed._get_pt(tr, v, ed._bg_color(tr))
    g = torch.Generator(device=dev).manual_seed(11)
    side = ed.RESIZE // 8                          # the latents' side
    draws = [dict(bg_color=torch.rand(3, generator=g, device=dev), t=400 + 200 * i,
                  noise=torch.randn(1, 4, side, side, generator=g, device=dev),
                  vae_noise=torch.randn(1, 4, side, side, generator=g, device=dev))
             for i in range(2)]
    saved = SavedState([*tr.field.parameters(), tr._count_t], tr.optimizer.state,
                       tr.generator)
    host = (tr.n_updates, tr.np_rng.get_state())
    probe = torch.Generator(device=dev)
    probe.set_state(tr.generator.get_state())
    seeds = torch.randint(0, 2 ** 62, (2,), generator=probe, device=dev).tolist()
    pe, oe, _ = _scene_state(tr, 2, ed)
    _, _, _, batched = ed.editing_step_scenes(tr, views[:2], pe, oe, draws)
    single = []
    for i in range(2):
        saved.restore()
        tr.n_updates = host[0]
        tr.np_rng.set_state(host[1])
        for _ in range(i):
            tr.np_rng.random()                    # scene i takes the i-th gate
        tr.generator.manual_seed(int(seeds[i]))
        _, aux1, _ = ed.editing_step(tr, views[i], draws=draws[i])
        single.append({k: float(v) for k, v in aux1.items()})
    saved.restore()
    tr.n_updates = host[0]
    tr.np_rng.set_state(host[1])
    rel = max(abs(float(batched[k][i]) - single[i][k]) / max(abs(single[i][k]), 1e-12)
              for i in range(2) for k in ("loss_sds", "loss_bg"))
    assert rel <= SCENE_LOSS_RTOL, (f"an S = 2 step's losses differ from two "
                                    f"single-scene steps by {rel:.3g} relative: "
                                    f"{batched} vs {single}")

    rows = [check_fused_mlp(*mlp_input[0], **mlp_input[1])] + dtable_rows(dt_input)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["path"] = "multi-scene editing S=2"
    med = statistics.median
    summary = {
        "steps": steps, "launches": launches, "single_step_launches": single_launches,
        "peak_gb": peak / 1e9, "field_moved": moved,
        "ms_s2": med(s["ms"] for s in steps), "ms_s4": med(s["ms"] for s in s4),
        "ms_single": med(single_ms), "unet_ms_s2": med(s["unet_ms"] for s in steps),
        "unet_ms_s4": med(s["unet_ms"] for s in s4), "unet_ms_single": med(single_unet),
        "vs_single_rel": rel, "vs_single": {"batched": {k: v.tolist() for k, v in batched.items()},
                                            "single": single},
    }
    return summary, rows


# ------------------------------------------------------------- data axis
DATA_AXIS_STEPS = 4
DATA_AXIS_WORKSPACE = os.path.join("chiprun_out", "smoke_data_axis")
DATA_AXIS_JOIN_S = 600


def data_axis_run(ckpt, mesh_shape, rank=0):
    """The flagship from ``ckpt`` (under ``mesh_shape``): DATA_AXIS_STEPS
    eager steps and one ``render_image``, the counters zeroed before and
    read after.  Returns the results and the last step's K1 / dT inputs."""
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.models import field
    from customnerf_torch.ops import triplane

    ws = os.path.join(DATA_AXIS_WORKSPACE, f"{mesh_shape or 'one'}_{rank}")
    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + ["--workspace", ws,
                                                    "--mesh_shape", mesh_shape])
    tr = Trainer(opt, use_checkpoint=ckpt, log=lambda *_: None)
    train = NeRFDataset(opt, "train", device=tr.device).dataloader()
    view = NeRFDataset(opt, "val", device=tr.device).dataloader().item(0)
    batches = [train.item(i % len(train)) for i in range(DATA_AXIS_STEPS)]
    lrs = [g["lr_scale"] * tr.lr_at(tr.n_updates) for g in tr.optimizer.param_groups]
    losses, ms = [], []
    with captured_calls(field, "fused_field_mlp", keep=4) as mlp_calls, \
            captured_calls(triplane, "plane_dtable", keep=6) as dt_calls:
        zero_counts()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.global_step += 1
            losses.append(float(tr.train_step(b)[0]))
            ms.append((time.perf_counter() - t0) * 1e3)
        mlp_input, dt_input = mlp_calls[-1], list(dt_calls)     # the last step's
        image = tr.render_image(view.rays_o, view.rays_d)["image"]
        torch.cuda.synchronize()
        launches = read_counts()
    out = {"losses": losses, "ms": ms, "launches": launches, "lr_grid_mlp": lrs,
           "params": {n: p.detach().cpu() for n, p in tr.field.named_parameters()},
           "image": image.cpu(), "backend": tr.mesh.backend if tr.mesh else None}
    return out, mlp_input, dt_input


def data_axis_worker(rank: int, port: str, ckpt: str, out: str) -> int:
    """One rank of phase 7b' (``chip_smoke.py --data-axis-worker``)."""
    import torch
    from customnerf_torch.parallel.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False        # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    assert init_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                            log=log)
    res, mlp_input, dt_input = data_axis_run(ckpt, "data:2", rank)
    if rank == 0:
        rows = [check_fused_mlp(*mlp_input[0], **mlp_input[1])] + dtable_rows(dt_input)
        for r in rows:
            r["launches"] = res["launches"][r["name"]]
            r["path"] = "data:2 reconstruction (rank 0)"
        res["rows"] = rows
        torch.save(res, out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_data_axis(ckpt):
    """Phase 7b': two worker processes under ``data:2`` against this
    process without a mesh.  Returns the summary and rank 0's rows."""
    import socket
    import subprocess
    import torch

    os.makedirs(DATA_AXIS_WORKSPACE, exist_ok=True)
    out = os.path.join(DATA_AXIS_WORKSPACE, "rank0.pt")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--data-axis-worker", str(r), port, ckpt, out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DATA_AXIS_JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"data:2 rank {r} failed (rc {p.returncode}):\n{text[-3000:]}"
    mesh = torch.load(out, weights_only=False)
    one, _, _ = data_axis_run(ckpt, "")
    backend_line = next(line for line in logs[0].splitlines() if "backend" in line)
    assert mesh["backend"] == "gloo", mesh["backend"]
    check_launched(mesh["launches"], (K1_BF16, DT_BF16), "data:2 reconstruction")
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(mesh["losses"], one["losses"]))
    assert rel <= LOSS_RTOL["reconstruction"], (mesh["losses"], one["losses"])
    lr_g, lr_m = mesh["lr_grid_mlp"]
    params = []
    for n, a in mesh["params"].items():
        b = one["params"][n]
        lr = (lr_g if n == "grid_table" else lr_m) * DATA_AXIS_STEPS
        d = (a - b).abs()
        q = {"name": n, "max_over_lr_steps": float(d.max()) / lr,
             "rms_over_lr_steps": float(d.pow(2).mean().sqrt()) / lr}
        assert q["max_over_lr_steps"] <= 2.0 and q["rms_over_lr_steps"] <= PARAM_RMS_LR, q
        params.append(q)
    img_err = (mesh["image"] - one["image"]).abs()
    assert float(img_err.max()) <= 2e-2 and float(img_err.mean()) <= 1e-3, \
        (float(img_err.max()), float(img_err.mean()))
    shutil.rmtree(DATA_AXIS_WORKSPACE, ignore_errors=True)
    summary = {"backend": backend_line, "losses": mesh["losses"],
               "losses_one_process": one["losses"], "loss_rel": rel,
               "ms_per_step": statistics.median(mesh["ms"]),
               "ms_per_step_one_process": statistics.median(one["ms"]),
               "params": params, "image_max_err": float(img_err.max()),
               "image_mean_err": float(img_err.mean()), "launches": mesh["launches"],
               "launches_one_process": one["launches"]}
    return summary, mesh["rows"]


# ------------------------------------------------------------ image-driven
CD_WORKSPACE = os.path.join("chiprun_out", "smoke_cd")
CD_STEPS, CD_CHECKPOINT, CD_CONCEPTS, CD_CLASS_IMAGES = 8, 4, 4, 2
CD_LR = 1e-5                  # scripts/tuning.sh's learning rate
CD_RESUME_TOL = 1e-3          # relative L2 of (resumed − straight) / change


def _cd_edit_flags(cd_dir, recon_ckpt, base=EDIT_FLAGS, workspace=CD_WORKSPACE):
    flags = _with(base, text="a <new1> bear in a forest", text_fg="a <new1> bear",
                  workspace=os.path.join(workspace, "edit"))
    return flags + ["--use_cd", cd_dir, "--editing_from", recon_ckpt]


def run_image_driven(guidance, clip_matcher, recon_ckpt):
    """JPEG concept images, DDIM class images, Custom Diffusion tuning with
    a checkpoint, a resume and a validation sample, then ``--use_cd``
    editing steps, on the full-width stack of the editing phase.  Returns
    the summary and the editing path's K1 and dT inputs."""
    import numpy as np
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.guidance import custom_diffusion as cd
    from customnerf_torch.guidance.retrieve import retrieve
    from customnerf_torch.utils import jpeg

    shutil.rmtree(CD_WORKSPACE, ignore_errors=True)
    concept_dir = os.path.join(CD_WORKSPACE, "concept")
    os.makedirs(concept_dir)
    frames = NeRFDataset(parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS), "train",
                         device=guidance.device).dataloader()
    for i in range(CD_CONCEPTS):
        b = frames.item(i)
        rgb = (b.rgbs.reshape(b.H, b.W, 3).clamp(0, 1) * 255).round().byte().cpu().numpy()
        jpeg.write_jpeg(os.path.join(concept_dir, f"view{i}.jpg"), rgb)

    class_dir = os.path.join(CD_WORKSPACE, "class")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = retrieve("bear", class_dir, CD_CLASS_IMAGES, guidance=guidance, seed=0)
    torch.cuda.synchronize()
    class_s = (time.perf_counter() - t0) / n
    shapes = {jpeg.read(os.path.join(class_dir, f)).shape
              for f in sorted(os.listdir(class_dir)) if f.endswith(".jpg")}
    assert n == CD_CLASS_IMAGES and shapes == {(512, 512, 3)}, (n, shapes)

    opt = parse_args(["--data_type", "synthetic", "--seed", "0"])
    base = cd.extract_cd_kv(guidance.unet)
    stamps, losses = [], []

    def on_step(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(loss)

    # the host's share of a step: the dataset's image reads and resizes
    host = {"s": 0.0}
    sample_instance, sample_class = cd.ConceptDataset.sample_instance, cd.ConceptDataset.sample_class

    def timed(fn):
        def run(self):
            t0 = time.perf_counter()
            out = fn(self)
            host["s"] += time.perf_counter() - t0
            return out
        return run

    straight = os.path.join(CD_WORKSPACE, "cd_straight")
    kw = dict(class_dir=class_dir, class_prompt="bear", lr=CD_LR, image_size=512,
              batch_size=2, guidance=guidance, log=lambda *_: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    cd.ConceptDataset.sample_instance = timed(sample_instance)
    cd.ConceptDataset.sample_class = timed(sample_class)
    try:
        cd.train_custom_diffusion(opt, concept_dir, "bear", straight, steps=CD_STEPS,
                                  checkpointing_steps=CD_CHECKPOINT,
                                  validation_prompt="photo of a <new1> bear",
                                  validation_steps=CD_STEPS, num_validation_images=1,
                                  on_step=on_step, **kw)
    finally:
        cd.ConceptDataset.sample_instance = sample_instance
        cd.ConceptDataset.sample_class = sample_class
    tune_peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    te = guidance.text_encoder
    base_row = te.model.text_model.embeddings.token_embedding.weight[
        te.tokenizer.add_token("<new1>")].detach().cpu()
    resumed = os.path.join(CD_WORKSPACE, "cd_resumed")
    shutil.copytree(os.path.join(straight, f"checkpoint-{CD_CHECKPOINT}"),
                    os.path.join(resumed, f"checkpoint-{CD_CHECKPOINT}"))
    resumed_losses = []
    cd.train_custom_diffusion(opt, concept_dir, "bear", resumed, steps=CD_STEPS,
                              checkpointing_steps=0, resume_from_checkpoint="latest",
                              on_step=lambda s, v: resumed_losses.append(v), **kw)
    a, ta = cd.load_cd_artifacts(straight)
    b, tb = cd.load_cd_artifacts(resumed)
    moved = {f"{k}.{n}": float((a[k][n] - base[k][n].cpu()).abs().max())
             for k in a for n in a[k]}
    moved["<new1>"] = float(np.abs(ta["<new1>"] - base_row.numpy()).max())
    num = sum(float(((a[k][n] - b[k][n]) ** 2).sum()) for k in a for n in a[k])
    den = sum(float(((a[k][n] - base[k][n].cpu()) ** 2).sum()) for k in a for n in a[k])
    resume_rel = math.sqrt(num / den)
    row_diff = float(np.abs(ta["<new1>"] - tb["<new1>"]).max())
    assert all(math.isfinite(v) for v in losses + resumed_losses), (losses, resumed_losses)
    assert len(losses) == CD_STEPS and len(resumed_losses) == CD_STEPS - CD_CHECKPOINT
    assert all(m > 0 for m in moved.values()), f"an adapter did not move: {moved}"
    assert len(a) == 16 and set(a) == set(base), sorted(a)
    assert resume_rel <= CD_RESUME_TOL, f"resumed run off by {resume_rel}"
    val = os.listdir(os.path.join(straight, "validation"))
    assert val == [f"step{CD_STEPS:05d}_0.png"], val
    art_bytes = {f: os.path.getsize(os.path.join(straight, f))
                 for f in ("pytorch_custom_diffusion_weights.bin", "<new1>.bin")}

    trainer, eopt, edit, mlp_input, dt_calls, eps_diff = cd_editing(
        guidance, clip_matcher, _cd_edit_flags(straight, recon_ckpt), EDIT_STEPS,
        "--use_cd editing")
    cd_dispatch, cd_dispatch_rows = editing_dispatch(
        trainer, NeRFDataset(eopt, "train", device=trainer.device).dataloader(),
        "use_cd editing dispatch (graph)")
    del trainer
    guidance.cd_kv = None
    summary = {
        "concept_images": CD_CONCEPTS, "class_images": n, "class_s_per_image": class_s,
        "tune_steps": CD_STEPS, "tune_losses": losses, "tune_step_ms": step_ms,
        "tune_median_step_ms": statistics.median(step_ms), "tune_peak_gb": tune_peak / 1e9,
        "tune_host_data_ms_per_step": host["s"] / CD_STEPS * 1e3,
        "resumed_losses": resumed_losses, "resume_rel_l2": resume_rel,
        "resume_token_row_max_diff": row_diff, "adapters": len(a),
        "adapter_min_change": min(moved.values()), "artifact_bytes": art_bytes,
        "eps_max_change_with_adapters": eps_diff,
        "dispatch": cd_dispatch, "dispatch_rows": cd_dispatch_rows, "edit": edit}
    return summary, mlp_input, dt_calls


def cd_editing(guidance, clip_matcher, flags, n_steps, path):
    """``--use_cd``: the artifacts in ``flags``' directory loaded into
    ``guidance`` (ε with the adapters must differ from ε without), then
    ``n_steps`` editing steps with ``<new1>`` in the prompts; counters
    zeroed before and read after, both kernels must launch.  Returns the
    trainer, its options, the steps' summary, K1's and dT's inputs and ε's
    largest change."""
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.engine.trainer import Trainer

    eopt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + flags)
    guidance.load_cd(eopt.use_cd)                # the --use_cd path of __init__
    ctx = guidance.get_text_embeds(["a <new1> bear"], [""])
    x = torch.randn(2, 4, 64, 64, generator=torch.Generator(device=guidance.device)
                    .manual_seed(0), device=guidance.device)
    t = torch.full((2,), 500, device=guidance.device)
    with torch.no_grad():
        eps_diff = float((guidance.unet(x, t, ctx, cd_kv=guidance.cd_kv)
                          - guidance.unet(x, t, ctx)).abs().max())
    assert eps_diff > 0, "the adapters do not change epsilon"
    trainer = Trainer(eopt, guidance=guidance, use_checkpoint=eopt.ckpt, log=lambda *_: None)
    trainer.clip_matcher = clip_matcher
    steps, launches, peak, base_mem, mlp_input, dt_calls, field_moved, _ = editing_steps(
        trainer, eopt, n_steps)
    check_launched(launches, (K1_BF16, DT_BF16), path)
    assert mlp_input[0][0].shape[0] == STEP_SAMPLES, mlp_input[0][0].shape
    assert guidance.text_encoder.tokenize(["a <new1> bear"])[0][2] == 49408
    edit = {"steps": steps, "launches": launches, "peak_gb": peak / 1e9,
            "resident_before_steps_gb": base_mem / 1e9, "field_max_change": field_moved,
            "median_ms": {k: statistics.median(s[k] for s in steps) for k in (
                "total", "pt_and_draws", "render_to_latents", "unet", "backward_adam")}}
    return trainer, eopt, edit, mlp_input, dt_calls, eps_diff


def run_drill(sd_version="1.5"):
    """``python -m customnerf_torch --validate_weights`` at full width with
    random weights, through ``__main__.main``: it must exit 0 without
    training, its report ``ok`` with ``sd_version``'s full-width parameter
    counts."""
    import contextlib
    import io
    import torch
    from customnerf_torch.__main__ import main as cli
    from customnerf_torch.guidance.sds import FULL_WIDTH_PARAMS, sd_family

    out, code = io.StringIO(), None
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        try:
            cli(["--validate_weights", "--data_type", "synthetic", "--seed", "0",
                 "--sd_version", sd_version])
        except SystemExit as e:
            code = e.code
    wall_s = time.time() - t0
    torch.cuda.empty_cache()
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    counts = {k: report[k]["params"] for k in ("unet", "vae", "text_encoder")}
    assert code == 0 and report["ok"] and report["sd_version"] == sd_version, (code, report)
    row = FULL_WIDTH_PARAMS[sd_family(sd_version)]
    assert counts == {k: row[k] for k in counts}, counts
    return {"sd_version": sd_version, "exit_code": code, "ok": report["ok"], "params": counts, "wall_s": wall_s,
            "eps_std": report["eps_prediction"]["std"],
            "vae_std": report["vae_encode"]["std"],
            "checksums": {k: report[k]["checksum"] for k in counts}}


# ------------------------------------------------------------------- SD 2.x
def _progressive_jpeg(path, rgb, quality=95):
    """``rgb`` as a progressive JPEG written by cv2 (the card's machine has
    cv2; the port does not use it): the witness the port's decode must
    equal."""
    import cv2
    import numpy as np
    ok = cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]),
                     [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with open(path, "rb") as f:
        assert ok and b"\xff\xc2" in f.read(), f"{path}: not a progressive JPEG"
    return path


def _decode_against_cv2(path):
    """The port's decode of ``path`` (seconds) and whether it equals
    ``cv2.imread`` with IGNORE_ORIENTATION bit for bit."""
    import cv2
    import numpy as np
    from customnerf_torch.utils import jpeg
    t0 = time.perf_counter()
    got = jpeg.read(path)
    secs = time.perf_counter() - t0
    want = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]
    return got, secs, bool(got.shape == want.shape and np.array_equal(got, want))


def run_sd2(recon_ckpt):
    """The SD 2.x phase (after the SD 1.5 stack is freed): the full-width
    2.1 stack on the card (its counts and dtypes), EDIT_STEPS text editing
    steps with stage times, the profiled step, the bounds and one dispatch
    of K = 8 against eager steps (``run_editing``), K1 and dT on that path's
    inputs; then image-driven editing under 2.1 (``run_sd2_image_driven``)
    and the weights drill under 2.1.  Returns the summary and the kernel
    rows."""
    import gc
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.sds import StableDiffusionGuidance

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SD2_WORKSPACE, ignore_errors=True)
    opt = parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS + SD2_EDIT_FLAGS
                     + ["--editing_from", recon_ckpt])
    guidance = StableDiffusionGuidance(opt)
    cfg = guidance.unet.cfg
    assert (cfg.cross_attention_dim, cfg.attention_head_dim) == (1024, (5, 10, 20, 20)), cfg
    assert guidance.text_encoder.model.text_model.cfg.hidden_act == "gelu"
    trainer = Trainer(opt, guidance=guidance, use_checkpoint=opt.ckpt, log=lambda *_: None)
    ed, mlp, dt = run_editing(trainer, opt, label=f"SD {SD2_VERSION} editing")
    rows = [check_fused_mlp(*mlp[0], **mlp[1])] + dtable_rows(dt)
    for r in rows:
        r["launches"] = ed["launches"][r["name"]]
        r["path"] = f"SD {SD2_VERSION} editing"
    rows += ed.pop("dispatch_rows")
    clip_matcher = trainer.clip_matcher
    del trainer
    cdp, cd_rows = run_sd2_image_driven(guidance, clip_matcher, recon_ckpt)
    rows += cd_rows
    del guidance, clip_matcher
    gc.collect()
    torch.cuda.empty_cache()
    drill = run_drill(SD2_VERSION)
    return {"editing": ed, "image_driven": cdp, "validate_weights": drill}, rows


def run_sd2_image_driven(guidance, clip_matcher, recon_ckpt):
    """Under 2.1: CD_CONCEPTS synthetic frames written as progressive JPEGs
    by cv2, decoded by the port equal to ``cv2.imread``; SD2_CLASS_IMAGES
    DDIM class image (25 steps at 512²), whose copies as baseline and
    progressive JPEGs (cv2, quality 95) time the decoder a megapixel;
    SD2_TUNE_STEPS tuning steps at full width (batch 2 with prior; every
    loss finite, every adapter [C, 1024] and the 1024-wide token row moved);
    then SD2_CD_EDIT_STEPS ``--use_cd`` editing steps (counters zeroed
    before and read after; both kernels must launch) with K1 and dT on
    their inputs."""
    import cv2
    import numpy as np
    import torch
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.guidance import custom_diffusion as cd
    from customnerf_torch.guidance.retrieve import retrieve

    concept_dir = os.path.join(SD2_WORKSPACE, "concept")
    os.makedirs(concept_dir)
    frames = NeRFDataset(parse_args(FLAGSHIP_ARGS + SMOKE_FLAGS), "train",
                         device=guidance.device).dataloader()
    concept_s, concept_px = 0.0, 0
    for i in range(CD_CONCEPTS):
        b = frames.item(i)
        rgb = (b.rgbs.reshape(b.H, b.W, 3).clamp(0, 1) * 255).round().byte().cpu().numpy()
        path = _progressive_jpeg(os.path.join(concept_dir, f"view{i}.jpg"), rgb)
        got, secs, equal = _decode_against_cv2(path)
        assert equal, f"{path}: the port's progressive decode differs from cv2.imread"
        concept_s += secs
        concept_px += got.shape[0] * got.shape[1]

    class_dir = os.path.join(SD2_WORKSPACE, "class")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = retrieve("bear", class_dir, SD2_CLASS_IMAGES, guidance=guidance, seed=0)
    torch.cuda.synchronize()
    class_s = (time.perf_counter() - t0) / n
    assert n == SD2_CLASS_IMAGES, n
    class_img, _, _ = _decode_against_cv2(os.path.join(class_dir, "00000.jpg"))
    decode = {}
    for kind, progressive in (("baseline", 0), ("progressive", 1)):
        path = os.path.join(SD2_WORKSPACE, f"class_{kind}.jpg")
        cv2.imwrite(path, np.ascontiguousarray(class_img[..., ::-1]),
                    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        got, secs, equal = _decode_against_cv2(path)
        assert equal, f"{path}: the port's decode differs from cv2.imread"
        decode[kind] = {"s": secs, "s_per_mpix": secs / (got.shape[0] * got.shape[1] / 1e6),
                        "bytes": os.path.getsize(path)}

    opt = parse_args(["--data_type", "synthetic", "--seed", "0", "--sd_version", SD2_VERSION])
    base = cd.extract_cd_kv(guidance.unet)
    stamps, losses = [], []

    def on_step(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(loss)

    out_dir = os.path.join(SD2_WORKSPACE, "cd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    cd.train_custom_diffusion(opt, concept_dir, "bear", out_dir, steps=SD2_TUNE_STEPS,
                              checkpointing_steps=0, class_dir=class_dir,
                              class_prompt="bear", lr=CD_LR, image_size=512, batch_size=2,
                              guidance=guidance, on_step=on_step, log=lambda *_: None)
    tune_peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    a, ta = cd.load_cd_artifacts(out_dir)
    moved = {f"{k}.{m}": float((a[k][m] - base[k][m].cpu()).abs().max())
             for k in a for m in a[k]}
    assert all(math.isfinite(v) for v in losses) and len(losses) == SD2_TUNE_STEPS, losses
    assert all(v > 0 for v in moved.values()), f"an adapter did not move: {moved}"
    assert len(a) == 16 and all(e["to_k"].shape[1] == 1024 for e in a.values())
    assert ta["<new1>"].shape == (1024,)

    flags = _cd_edit_flags(out_dir, recon_ckpt, base=SD2_EDIT_FLAGS,
                           workspace=os.path.join(SD2_WORKSPACE, "cd"))
    trainer, _, edit, mlp_input, dt_calls, eps_diff = cd_editing(
        guidance, clip_matcher, flags, SD2_CD_EDIT_STEPS, f"SD {SD2_VERSION} --use_cd editing")
    del trainer
    guidance.cd_kv = None
    rows = [check_fused_mlp(*mlp_input[0], **mlp_input[1])] + dtable_rows(dt_calls)
    for r in rows:
        r["launches"] = edit["launches"][r["name"]]
        r["path"] = f"SD {SD2_VERSION} use_cd editing"
    return {
        "concept_images": CD_CONCEPTS, "concept_decode_s": concept_s,
        "concept_decode_s_per_mpix": concept_s / (concept_px / 1e6),
        "class_images": n, "class_s_per_image": class_s, "class_decode": decode,
        "tune_steps": SD2_TUNE_STEPS, "tune_losses": losses, "tune_step_ms": step_ms,
        "tune_median_step_ms": statistics.median(step_ms), "tune_peak_gb": tune_peak / 1e9,
        "adapters": len(a), "adapter_min_change": min(moved.values()),
        "eps_max_change_with_adapters": eps_diff, "edit": edit}, rows


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
# the parity step's device spans (engine/spans.py); "total" is recon.step
PARITY_STAGES = ("coarse", "resample", "fine", "composite", "loss", "backward", "adam")


def grid_consistency(x01, table, spec, n=65536):
    """``grid_encode`` on the card (the kernels) against the same call on
    the CPU (the plain encoder), for the parity spec and its hash twin (same
    sizes), on ``n`` of the step's fine points: the output and the table
    gradient (atomics on the card)."""
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
    after; K1 and both grid kernels must launch (dT is not on this path).
    Returns (trainer, opt, summary, K1's inputs at the last step's fine and
    coarse pass, the last fine and coarse passes' encode inputs)."""
    import torch
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer, psnr
    from customnerf_torch.models import field
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
                           when=lambda a, k: torch.is_grad_enabled()) as enc, \
            captured_calls(field, "encode_positions", keep=1,
                           when=lambda a, k: a[0].reshape(-1, 3).shape[0]
                           == PARITY_COARSE) as enc_coarse:
        # the parity path starts here: counters read only its launches
        zero_counts()
        t_start = time.time()
        for _ in range(PARITY_STEPS):
            batch = train.item(0)
            trainer.global_step += 1
            torch.cuda.synchronize()
            (loss, aux, _), wall, ms, _ = traced(lambda: trainer.train_step(batch))
            steps.append(dict({k: ms[k] for k in PARITY_STAGES}, total=ms["recon.step"],
                              ms=wall, loss=float(loss)))
        view = val.item(0)
        out = trainer.render_image(view.rays_o, view.rays_d)
        torch.cuda.synchronize()
        wall_s = time.time() - t_start
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    check_launched(launches, GRID_PATH, "parity")
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
                             for k in PARITY_STAGES + ("total", "ms")},
               "psnr_val0": psnr(img, view.rgbs.reshape(-1, 3))}
    summary["rays_per_s"] = STEP_RAYS / summary["median_ms"]["ms"] * 1e3
    return trainer, opt, summary, at_fine[-1], at_coarse[-1], enc[-1][0], enc_coarse[-1][0]


def grid_rows(coarse_x, fine_x, table, spec, launches):
    """The grid encode's kernels (``csrc/grid_encode.cu``) against the plain
    encoder on the card, on the parity step's own points: the coarse pass's
    forward, the fine pass's forward and its backward to the table.  Device
    times of the kernel, of a wrapper call with the host in the loop, of the
    plain version and of the one library call it holds (``index_select``
    forward, ``index_add_`` backward, on precomputed rows and values).  The
    least time: a forward's from ``benchmark/lib/counts.py::grid_encode_step``;
    the backward's for this call alone, which asks for no dx and so never
    reads the table: coordinates and cotangent in, the gradient written once.
    Tolerance: forward 1e-5 of the largest output (the same products and
    sum order); backward, in each row, 1e-5 of that row's sum of magnitudes
    Σ|w·g| (the error is given relative to it): both sides add the same f32
    terms, in orders the atomics set, and a coarse row takes thousands of
    terms of either sign, so its sum is far smaller than the mass its
    rounding scales with; a row of one term must be exact."""
    import torch
    from benchmark.lib import counts
    from customnerf_torch.engine.measure import device_ms
    from customnerf_torch.ops import grid

    L, C, n_rows = spec.num_levels, spec.level_dim, spec.table_size
    table = table.detach()

    def row(name, shape, got, want, k_ms, call_ms, p_ms, lib_ms, work, n, mass=None):
        if mass is None:
            err, tol = float((got - want).abs().max()), 1e-5 * float(want.abs().max())
        else:
            err = float(((got - want).abs() / mass.clamp(min=1e-30)).max())
            tol = 1e-5
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: max_abs_err {err} > tol {tol}")
        b_ms, b_by = bound(*work)
        return {"name": name, "shape": shape, "route": "cuda",
                "source": "customnerf_torch/csrc/grid_encode.cu",
                "replaces": "none (the JAX encoder is plain XLA); the plain "
                            "encoder of customnerf_torch/ops/grid.py",
                "max_abs_err": err, "tolerance": tol, "ms": k_ms, "kernel_ms": k_ms,
                "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "bound_peak": "HBM3 3.35 TB/s; f32 67 TFLOP/s",
                "library_ms": lib_ms, "other_mode_ms": None, "launches": n,
                "path": "parity reconstruction"}

    rows = []
    with torch.no_grad():
        for label, x in (("coarse", coarse_x), ("fine", fine_x)):
            x = x.reshape(-1, 3).float().contiguous()
            B = x.shape[0]
            got = grid.grid_encode(x, table, spec)
            want = grid._encode_forward(x, table, spec, L)
            idx = grid._corners(x, spec, L)[0].reshape(-1)
            rows.append(row(
                GRID, f"{label} forward, B={B} L={L} C={C} rows={n_rows}", got, want,
                device_ms(lambda: grid._kernel_forward(x, table, spec, L), 10),
                device_ms(lambda: grid.grid_encode(x, table, spec), 10, host_ahead=False),
                device_ms(lambda: grid._encode_forward(x, table, spec, L), 3),
                device_ms(lambda: table.index_select(0, idx), 3),
                counts.grid_encode_step(B, 0, L, C, n_rows), launches[GRID]))
            del got, want, idx
    B = x.shape[0]
    g = torch.randn(B, spec.output_dim, device=x.device,
                    generator=torch.Generator(x.device).manual_seed(0))
    got = grid._kernel_backward(x, table, g, spec, L, False, True)[1]
    want = grid._plain_backward(x, table, g, spec, L, False, True)[1]
    t = table.clone().requires_grad_(True)
    out = grid.grid_encode(x, t, spec)
    idx, factors, _ = grid._corners(x, spec, L)
    idx = idx.reshape(-1)
    vals = (grid._weights(factors)[..., None] * g.reshape(B, L, 1, C)).reshape(-1, C)
    into = torch.zeros_like(table)
    mass = torch.zeros_like(table).index_add_(0, idx, vals.abs())
    del factors
    rows.append(row(
        GRID_BWD, f"fine backward (table gradient), B={B} L={L} C={C} rows={n_rows}",
        got, want,
        device_ms(lambda: grid._kernel_backward(x, table, g, spec, L, False, True), 10),
        device_ms(lambda: torch.autograd.grad(out, t, g, retain_graph=True), 10,
                  host_ahead=False),
        device_ms(lambda: grid._plain_backward(x, table, g, spec, L, False, True), 3),
        device_ms(lambda: into.index_add_(0, idx, vals), 3),
        (2.0 * B * L * 8 * C, 4.0 * (B * 3 + B * L * C + n_rows * C)),
        launches[GRID_BWD], mass))
    return rows


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
    check_launched(launches, GRID_PATH, "parity editing")
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
# the parity bear run writes its checkpoints off the training thread
ASYNC_CKPT = ["--ckpt_format", "orbax"]
# final eval PSNR gates: the JAX package's anchor on each fixture less the
# 0.5 dB band of docs/PARITY.md:151-216 (25.34, 25.01 and 25.28 dB; the
# parity field's 25.55, docs/PARITY.md:166)
QUALITY_GATES = {"nerfstudio": 24.84, "llff": 24.51, "dtu": 24.78}
PARITY_GATE = 25.05
BOTH_KERNELS = (K1_BF16, DT_BF16)    # bear.sh's flags: the default policy
# the flagship bear reads the reference layout (JPEG images, PNG masks)
QUALITY_RUNS = [
    {"name": t, "data_type": t, "flags": BEAR_PHASE1, "gate": g,
     "kernels": BOTH_KERNELS, "jpeg": t == "nerfstudio"}
    for t, g in QUALITY_GATES.items()] + [
    {"name": "nerfstudio_parity", "data_type": "nerfstudio",
     "flags": BEAR_PARITY + ASYNC_CKPT, "gate": PARITY_GATE, "kernels": GRID_PATH}]
TEST_FRAMES = 73              # the bear's slerp test path: 3 gaps × 25 − 2


def start_fixtures():
    """One writer process a format (the scripts' scene code with the PNG
    stand-in for cv2), started while the kernels build."""
    import subprocess
    shutil.rmtree(QUALITY_ROOT, ignore_errors=True)
    os.makedirs(QUALITY_ROOT)
    return {t: subprocess.Popen(
        [sys.executable, "-m", "customnerf_torch.data.fixtures", QUALITY_ROOT,
         "--data_type", t] + (["--jpeg"] if t == "nerfstudio" else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
    from customnerf_torch.ops import triplane

    name, data_type, base_flags = run["name"], run["data_type"], run["flags"]
    ws = os.path.join(QUALITY_ROOT, f"ws_{name}")
    flags = base_flags + ["--data_type", data_type, "--data_path", data_path,
                          "--workspace", ws]
    step_ms, in_step = [], [False]
    saves = {"write_s": 0.0, "wait_s": 0.0, "bytes": 0, "files": 0}
    train_many, write, wait, write_file = (Trainer.train_many, Trainer._write,
                                           Trainer.wait_for_saves, ckpt_io.write_checkpoint)

    def timed_many(self, batches):
        # the quality runs take the card's default: dispatches of 8 steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        in_step[0] = True
        out = train_many(self, batches)
        in_step[0] = False
        torch.cuda.synchronize()
        step_ms.extend([(time.perf_counter() - t0) * 1e3 / len(batches)] * len(batches))
        return out

    def timed_write(self, *a, **kw):
        # the time a save holds the training thread (all of the write when
        # synchronous; the snapshot and the wait for the previous write
        # under --ckpt_format orbax)
        t0 = time.perf_counter()
        out = write(self, *a, **kw)
        saves["write_s"] += time.perf_counter() - t0
        return out

    def timed_wait(self):
        t0 = time.perf_counter()
        wait(self)
        saves["wait_s"] += time.perf_counter() - t0

    def counted_file(path, state):
        out = write_file(path, state)
        saves["bytes"] += _disk_bytes(path)
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
        Trainer.train_many, Trainer._write = timed_many, timed_write
        Trainer.wait_for_saves, ckpt_io.write_checkpoint = timed_wait, counted_file
        stack.callback(setattr, Trainer, "train_many", train_many)
        stack.callback(setattr, Trainer, "_write", write)
        stack.callback(setattr, Trainer, "wait_for_saves", wait)
        stack.callback(setattr, ckpt_io, "write_checkpoint", write_file)
        # this path starts here: counters read only its launches
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        trainer = cli(flags, log=quiet)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        launches = read_counts(graphed=True)

    results = trainer.stats["results"]
    final, best = -results[-1], -trainer.stats["best_result"]
    strips = sorted(os.listdir(os.path.join(ws, "validation")))
    ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    test_dir = os.path.join(ws, "results", f"df_ep{trainer.epoch:04d}_test")
    ckpt_s = saves["write_s"] + saves["wait_s"]
    summary = {"name": name, "data_type": data_type, "final_psnr": final,
               "best_psnr": best, "psnr_by_epoch": [-r for r in results],
               "steps": len(step_ms), "median_step_ms": statistics.median(step_ms),
               "mean_step_ms": statistics.mean(step_ms), "wall_s": wall_s,
               "checkpoint_s": ckpt_s, "checkpoint_share": ckpt_s / wall_s,
               "checkpoint_write_block_s": saves["write_s"],
               "checkpoint_wait_s": saves["wait_s"],
               "ckpt_format": trainer.opt.ckpt_format,
               "steps_per_dispatch": trainer.steps_per_dispatch(),
               "checkpoint_files": saves["files"], "checkpoint_bytes": saves["bytes"],
               "validation_strips": len(strips), "checkpoints": ckpts,
               "test_frames": len(os.listdir(test_dir)), "launches": launches,
               "gate": run["gate"], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    check_launched(launches, run["kernels"], name)
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


def jpeg_layout(png_dir, jpg_dir):
    """Decode seconds of the JPEG layout's views (``utils/jpeg.py``) and
    their PSNR against the PNGs they were encoded from."""
    import numpy as np
    from customnerf_torch.utils import jpeg, png
    names = sorted(os.listdir(os.path.join(jpg_dir, "images")))
    t0 = time.perf_counter()
    imgs = [jpeg.read(os.path.join(jpg_dir, "images", n)) for n in names]
    decode_s = time.perf_counter() - t0
    psnrs = []
    for n, img in zip(names, imgs):
        ref = png.read_rgb(os.path.join(png_dir, "images", n[:-4] + ".png")).astype(np.float64)
        psnrs.append(10 * math.log10(255.0 ** 2 / float(((img - ref) ** 2).mean())))
    mp = sum(i.shape[0] * i.shape[1] for i in imgs) / 1e6
    return {"views": len(names), "decode_s": decode_s, "megapixels": mp,
            "s_per_megapixel": decode_s / mp, "psnr_db_mean": statistics.mean(psnrs),
            "psnr_db_min": min(psnrs)}


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
        data_path = paths[data_type]
        layout = None
        if run.get("jpeg"):
            layout = jpeg_layout(data_path, data_path + "_jpeg")
            data_path += "_jpeg"
            log(f"[quality {name}] reference layout: {layout['views']} JPEG views "
                f"decoded in {layout['decode_s']:.2f} s ({layout['s_per_megapixel']:.2f} "
                f"s/megapixel, utils/jpeg.py); PSNR against the PNGs "
                f"{layout['psnr_db_mean']:.2f} dB mean, {layout['psnr_db_min']:.2f} min")
        summary, inputs = run_quality(run, data_path, capture_k1=bear,
                                      capture_dt=bear and flagship,
                                      autotune=bear and flagship)
        summary["fixture_wait_s"] = waited
        summary["jpeg_layout"] = layout
        log(f"[quality {name}] final eval PSNR {summary['final_psnr']:.2f} dB "
            f"(best {summary['best_psnr']:.2f}, gate >= {summary['gate']}) | median "
            f"step {summary['median_step_ms']:.2f} ms over {summary['steps']} | wall "
            f"{summary['wall_s']:.1f} s, checkpoints {summary['checkpoint_s']:.1f} s "
            f"({100 * summary['checkpoint_share']:.1f} %, {summary['checkpoint_files']} "
            f"files, {summary['checkpoint_bytes'] / 1e9:.2f} GB) | "
            f"{summary['validation_strips']} strips | peak {summary['peak_gb']:.2f} GB "
            f"| K = {summary['steps_per_dispatch']}, --ckpt_format "
            f"{summary['ckpt_format']}: saves blocked {summary['checkpoint_write_block_s']:.1f} s, "
            f"waits {summary['checkpoint_wait_s']:.1f} s | launches {summary['launches']}")
        if "autotune" in summary:
            a = summary["autotune"]
            log(f"[autotune {name}] measured slab fill {a['slab_fill']:.4f} on the "
                f"trained grid -> --compact_frac {a['compact_frac']:.4f} (block "
                f"{a['compact_block']}); the recipe fixes {a['recipe_compact_frac']}")
        if bear:
            summary["test"] = run_test_render(run, data_path)
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
                run_rows += dtable_rows(inputs["dtable"])
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
    recon, opt, pa, fine, coarse, enc_args, enc_coarse = run_parity()
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
    # (b) the parity step as dispatches of K = 8, then (d) its checkpoints
    from customnerf_torch.data.base import NeRFDataset
    train = NeRFDataset(opt, "train", device=recon.device).dataloader()
    batches = [train.item(i % len(train)) for i in range(PARITY_DISPATCHES * GRAPH_K)]
    pa["dispatch"], mlp, _ = dispatch_check(recon, batches, "reconstruction",
                                            "parity dispatch (graph)")
    check_launched(pa["dispatch"]["graph_launches"], GRID_PATH, "parity dispatch")
    rows += dispatch_rows(mlp, None, pa["dispatch"], with_dt=False)
    pa["checkpoint"] = checkpoint_blocking(recon, batches[:GRAPH_K], "parity")
    g_rows = grid_rows(enc_coarse[0], *enc_args, pa["launches"])
    for r in g_rows:
        log_row(r)
    rows += g_rows
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


def log_sd2(card, sd2, ed15, cdp15):
    """The SD 2.x phase's lines, each beside SD 1.5's number of this run."""
    ed, cdp, drill = sd2["editing"], sd2["image_driven"], sd2["validate_weights"]
    med, med15 = ed["median_ms"], ed15["median_ms"]
    log(f"[SD {SD2_VERSION}] full-width stack, UNet and VAE in {ed['sd_dtype']} (text "
        f"towers f32), parameters {ed['param_counts']}, built on the card in "
        f"{ed['sd_init_s']:.2f} s (SD 1.5: {ed15['sd_init_s']:.2f} s)")
    log(f"[SD {SD2_VERSION} editing] {card} | {EDIT_STEPS} steps of {STEP_RAYS} rays | "
        f"median {med['total']:.1f} ms/step (SD 1.5 {med15['total']:.1f}; pt cached "
        f"{ed['median_ms_pt_cached']} vs {ed15['median_ms_pt_cached']}): render to latents "
        f"{med['render_to_latents']:.1f}, UNet {med['unet']:.1f} (SD 1.5 "
        f"{med15['unet']:.1f}), backward + Adam {med['backward_adam']:.1f} | peak "
        f"{ed['peak_gb']:.2f} GB (SD 1.5 {ed15['peak_gb']:.2f}) | local steps "
        f"{ed['local_steps']}/{EDIT_STEPS} | launches {ed['launches']}")
    d, d15 = ed["dispatch"], ed15["dispatch"]
    log(f"[SD {SD2_VERSION} editing dispatch] eager {d['median_eager_ms']:.2f} -> graphed "
        f"{d['median_graph_ms']:.2f} ms/step (SD 1.5 {d15['median_eager_ms']:.2f} -> "
        f"{d15['median_graph_ms']:.2f}); graphed step span {d['step_span_ms']:.2f} ms; "
        f"peak {d['graph_peak_gb']:.2f} GB (SD 1.5 "
        f"{d15['graph_peak_gb']:.2f})")
    for name, b in ed["sd_bounds"].items():
        log(f"[SD {SD2_VERSION} bound] {name}: {b['flops'] / 1e12:.3f} TFLOP, "
            f"{b['bytes'] / 1e9:.3f} GB -> {b['bound_ms']:.2f} ms ({b['bound_by']})")
    em = cdp["edit"]["median_ms"]
    dec = cdp["class_decode"]
    log(f"[SD {SD2_VERSION} image-driven] {cdp['concept_images']} progressive JPEG concept "
        f"images equal to cv2.imread (decoded at {cdp['concept_decode_s_per_mpix']:.2f} s/MP) "
        f"| 512x512 decode: baseline {dec['baseline']['s_per_mpix']:.2f}, progressive "
        f"{dec['progressive']['s_per_mpix']:.2f} s/MP | DDIM class image "
        f"{cdp['class_s_per_image']:.2f} s (SD 1.5 {cdp15['class_s_per_image']:.2f}) | "
        f"tuning {cdp['tune_steps']} steps: median {cdp['tune_median_step_ms']:.1f} ms "
        f"(SD 1.5 {cdp15['tune_median_step_ms']:.1f}), peak {cdp['tune_peak_gb']:.2f} GB, "
        f"losses {[round(v, 4) for v in cdp['tune_losses']]}")
    log(f"[SD {SD2_VERSION} use_cd editing] {SD2_CD_EDIT_STEPS} steps | median "
        f"{em['total']:.1f} ms/step (SD 1.5 {cdp15['edit']['median_ms']['total']:.1f}), "
        f"UNet {em['unet']:.1f} | peak {cdp['edit']['peak_gb']:.2f} GB | launches "
        f"{cdp['edit']['launches']}")
    log(f"[SD {SD2_VERSION} validate_weights] exit {drill['exit_code']}, ok {drill['ok']}, "
        f"params {drill['params']}, {drill['wall_s']:.1f} s")


# -------------------------------------------------------------- host inputs
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "jax_orbax")
ORBAX_NAME = "df_ep0002"
# tools/write_orbax_fixture.py's flags (the fixture's field), K left to the card
ORBAX_FLAGS = ("-O --grid_type triplane --triplane_res 16 32 --triplane_channels 8 4 "
               "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
               "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
               "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01 "
               "--h 16 --w 16 --train_size 4 --update_extra_interval 2 "
               "--max_ray_batch 1000").split()
ORBAX_WORKSPACE = os.path.join("chiprun_out", "smoke_orbax")
ORBAX_READS = 5
DROPPED_HW = (240, 320)


def record_jpeg_decodes():
    """Keep the bytes of every JPEG the phases decode (``utils/jpeg.py::
    decode_coefficients``, by file name, the first read of each) for the
    host phase.  Returns the dict and the undo function."""
    from customnerf_torch.utils import jpeg
    base, seen = jpeg.decode_coefficients, {}

    def keep(data, name="<bytes>", plain=False):
        if not plain and name not in seen:
            seen[name] = bytes(data)
        return base(data, name, plain=plain)

    jpeg.decode_coefficients = keep
    return seen, lambda: setattr(jpeg, "decode_coefficients", base)


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def jpeg_file_check(name, data, smoothed=False):
    """One file: the host library's coefficients against the plain loops',
    the decode against ``cv2.imdecode`` (IGNORE_ORIENTATION) bit for bit,
    and the seconds of each path, whole-file and entropy stage alone (the
    stages after it run the same code on the same coefficients, timed on
    each path's own)."""
    import cv2
    import numpy as np
    from customnerf_torch.utils import jpeg
    (f, native), native_entropy_s = _timed(jpeg.decode_coefficients, data, name)
    (fp, plain), plain_entropy_s = _timed(jpeg.decode_coefficients, data, name, plain=True)
    assert len(native) == len(plain) and all(
        np.array_equal(a, b) for a, b in zip(native, plain)), f"{name}: coefficients differ"
    got, native_rest_s = _timed(jpeg.reconstruct, f, native, name)
    plain_img, plain_rest_s = _timed(jpeg.reconstruct, fp, plain, name)
    assert np.array_equal(got, plain_img), f"{name}: the two paths' images differ"
    want = cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]
    r = {"name": os.path.basename(name), "hw": list(got.shape[:2]),
         "megapixels": got.shape[0] * got.shape[1] / 1e6,
         "progressive": bool(f.progressive),
         "smoothed": jpeg.smoothing_latch(f) is not None,
         "native_s": native_entropy_s + native_rest_s,
         "plain_s": plain_entropy_s + plain_rest_s,
         "native_entropy_s": native_entropy_s, "plain_entropy_s": plain_entropy_s,
         "cv2_equal": bool(np.array_equal(got, want))}
    if smoothed:
        rows = jpeg._smoothing_rows
        jpeg._smoothing_rows = jpeg._clamped_smoothing_rows
        try:
            clamped = jpeg.reconstruct(f, native, name)
        finally:
            jpeg._smoothing_rows = rows
        r["cv2_equal_clamped_rows"] = bool(np.array_equal(clamped, want))
        r["cv2_unequal_pixels"] = int((got != want).any(-1).sum())
        assert r["smoothed"], f"{name}: expected a smoothed file"
        assert r["cv2_equal"] or r["cv2_equal_clamped_rows"], \
            f"{name}: equal to cv2 under neither smoothing row rule ({r})"
    else:
        assert r["cv2_equal"], f"{name}: the decode differs from cv2.imdecode"
    return r


def dropped_scan_files():
    """Progressive files written by cv2 at DROPPED_HW with scans dropped:
    (name, bytes, one block row an iMCU row)."""
    import cv2
    import numpy as np
    from customnerf_torch.utils import jpeg
    h, w = DROPPED_HW
    yy, xx = np.mgrid[0:h, 0:w]
    rs = np.random.RandomState(0)
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, ((xx - yy) * 2) % 256], -1)
    img = np.clip(img + rs.randn(h, w, 3) * 20.0, 0, 255).astype(np.uint8)
    out = []
    for layout in ("420", "444", "gray", "restart"):
        params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if layout != "gray":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444 if layout == "444"
                       else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
        if layout == "restart":
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
        ok, enc = cv2.imencode(".jpg", img[..., 0] if layout == "gray"
                               else np.ascontiguousarray(img[..., ::-1]), params)
        assert ok
        data = enc.tobytes()
        scans = []            # (start, end, ids, Ss, Se, Ah, Al) of each SOS
        pos = 2
        while data[pos + 1] != 0xD9:
            end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
            if data[pos + 1] == 0xDA:
                body = data[pos + 4:]
                ns = body[0]
                info = ([body[1 + 2 * i] for i in range(ns)], body[1 + 2 * ns],
                        body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15)
                while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                    end += 1
                scans.append((pos, end) + tuple(info))
            pos = end
        luma, last = scans[0][2][0], scans[-1]
        rules = {"last_refinement": lambda s: s == last,
                 "luma_ac_first": lambda s: s[2] == [luma] and s[3] > 0
                 and (s[3] > 1 or s[5] > 0),
                 "one_component_ac": lambda s: s[2] == [last[2][0]] and s[3] > 0}
        for drop, rule in rules.items():
            cut = data
            for sc in sorted((sc for sc in scans if rule(sc)), key=lambda sc: -sc[0]):
                cut = cut[:sc[0]] + cut[sc[1]:]
            out.append((f"dropped_{layout}_{drop}.jpg", cut, layout in ("444", "gray")))
    assert all(jpeg.smoothing_latch(jpeg.decode_coefficients(d, n)[0]) is not None
               for n, d, _ in out)
    return out


def run_host_jpeg(recorded):
    """Phase 10a."""
    files = [jpeg_file_check(n, d) for n, d in sorted(recorded.items())]
    dropped = []
    for name, data, one_row in dropped_scan_files():
        r = jpeg_file_check(name, data, smoothed=True)
        if one_row:
            assert r["cv2_equal"] and r["cv2_equal_clamped_rows"], r
        dropped.append(r)

    def per_mp(rs, key):
        mp = sum(r["megapixels"] for r in rs)
        return sum(r[key] for r in rs) / mp if mp else float("nan")

    summary = {"files": files, "dropped": dropped}
    for label, rs in (("baseline", [r for r in files if not r["progressive"]]),
                      ("progressive", [r for r in files if r["progressive"]]),
                      ("smoothed", dropped)):
        summary[label] = {k: per_mp(rs, k) for k in
                          ("native_s", "plain_s", "native_entropy_s", "plain_entropy_s")}
        summary[label]["files"] = len(rs)
        summary[label]["megapixels"] = sum(r["megapixels"] for r in rs)
        if rs:
            q = summary[label]
            q["whole_speedup"] = q["plain_s"] / q["native_s"]
            q["entropy_speedup"] = q["plain_entropy_s"] / q["native_entropy_s"]
    summary["cv2_row_rule"] = ("clamped (libjpeg-turbo 3.x)"
                               if all(r["cv2_equal_clamped_rows"] for r in dropped)
                               else "libjpeg-turbo 2.1's")
    for label in ("baseline", "progressive"):
        q = summary[label]
        assert q["files"] > 0, f"no {label} JPEG was decoded by the phases"
        assert q["whole_speedup"] >= 4.0 or q["entropy_speedup"] >= 10.0, (label, q)
    return summary


def _npz_tree(npz):
    """The fixture's expected arrays: (model tree flattened, meta)."""
    model = {k[len("model."):]: npz[k] for k in npz.files if k.startswith("model.")}
    meta = {k[len("meta."):]: npz[k] for k in npz.files if k.startswith("meta.")}
    return model, meta


def run_host_orbax():
    """Phases 10b and 10c.  Returns (summary, K1 and dT rows)."""
    import numpy as np
    import torch
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import checkpoint as ckpt_io
    from customnerf_torch.engine import editing as ed
    from customnerf_torch.engine.convert import adam_from_torch, params_to_flax
    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.ocdbt import OcdbtStore
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.models import field
    from customnerf_torch.models.field import param_names
    from customnerf_torch.ops import triplane

    shutil.rmtree(ORBAX_WORKSPACE, ignore_errors=True)
    ckpts = os.path.join(ORBAX_WORKSPACE, "resume", "checkpoints")
    os.makedirs(ckpts)
    path = os.path.join(ckpts, ORBAX_NAME + ".orbax")
    shutil.copytree(os.path.join(ORBAX_FIXTURE, ORBAX_NAME + ".orbax"), path)
    model, meta_want = _npz_tree(np.load(os.path.join(ORBAX_FIXTURE, ORBAX_NAME + ".npz")))
    read_ms, open_ms = [], []
    for _ in range(ORBAX_READS):
        store, secs = _timed(OcdbtStore, path)      # manifest and B+tree alone
        store.close()
        open_ms.append(secs * 1e3)
        (params, meta), secs = _timed(ckpt_io.load_checkpoint, path)
        read_ms.append(secs * 1e3)
    flat = ckpt_io.flatten(params)
    nbytes = sum(a.nbytes for a in flat.values()) + sum(
        np.asarray(v).nbytes for k, v in meta.items() if k in meta_want)
    assert sorted(flat) == sorted(model)
    for k, v in model.items():
        assert flat[k].dtype == v.dtype and flat[k].tobytes() == v.tobytes(), k

    opt = parse_args(ORBAX_FLAGS + ["--workspace", os.path.dirname(ckpts)])
    lines = []
    tr = Trainer(opt, use_checkpoint="latest", log=lines.append)
    assert any(ORBAX_NAME + ".orbax" in l for l in lines), lines
    assert "[INFO] loaded optimizer." in lines and not any("WARN" in l for l in lines), lines
    # (e) its Adam state: the fixture's optimizer leaves as the JAX package
    # restores them (df_ep0002_opt.npz), by their roles in the optax state
    leaves = np.load(os.path.join(ORBAX_FIXTURE, ORBAX_NAME + "_opt.npz"))
    adam = adam_from_torch(tr.optimizer.state_dict(), param_names(tr.field),
                           tr.field.state_dict())
    moments = {what: ckpt_io.flatten(params_to_flax(
        {n: v.detach().cpu() for n, v in adam[name].items()}))
        for what, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    roles = tr.optax_layout().roles
    assert len(roles) == len(leaves.files) - 1
    for i, (what, _, fpath) in enumerate(roles):
        leaf = leaves[f"optimizer.leaves.{i}"]
        if what in moments:
            assert moments[what][fpath].tobytes() == leaf.tobytes(), (i, what, fpath)
        elif what == "found_nan":
            assert tr._found_nan[fpath] == bool(leaf), (i, fpath)
        else:
            assert tr.n_updates == int(leaf), (i, what)
    assert all(float(st["step"]) == tr.n_updates for st in tr.optimizer.state.values())
    resumed_updates = tr.n_updates
    assert (tr.epoch, tr.global_step) == (int(meta_want["epoch"]), int(meta_want["global_step"]))
    got = ckpt_io.flatten(params_to_flax(
        {k: v.detach().cpu() for k, v in tr.field.state_dict().items()}))
    for k, v in model.items():
        assert got[k].tobytes() == v.tobytes(), f"{k}: the resumed trainer differs from the .npz"
    for k, t in (("density_grid", tr.occ_state.density_grid),
                 ("density_bitfield", tr.occ_state.bitfield)):
        assert t.cpu().numpy().tobytes() == meta_want[k].tobytes(), k
    assert tr.steps_per_dispatch() == GRAPH_K
    train = NeRFDataset(opt, "train", device=tr.device).dataloader()
    batches = [train.item(i % len(train)) for i in range(GRAPH_K)]
    before = [p.detach().clone() for p in tr.field.parameters()]
    zero_counts()
    with captured_calls(field, "fused_field_mlp", keep=1,
                        when=lambda a, k: torch.is_grad_enabled()) as mlp, \
            captured_calls(triplane, "plane_dtable", keep=6) as dt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = tr.train_many(batches)[0]
        torch.cuda.synchronize()
        dispatch_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(graphed=True)
    tr.global_step += len(batches)
    check_launched(launches, (K1_BF16, DT_BF16), ".orbax resume (graph)")
    losses = losses.tolist()
    assert all(math.isfinite(v) for v in losses), losses
    assert all(not torch.equal(a, b) for a, b in zip(before, tr.field.parameters()))
    summary = {"read_ms": read_ms, "read_ms_median": statistics.median(read_ms),
               "store_open_ms_median": statistics.median(open_ms),
               "decompressed_bytes": nbytes,
               "read_mb_per_s": nbytes / 1e6 / (statistics.median(read_ms) / 1e3),
               "epoch": tr.epoch, "n_updates": resumed_updates, "losses": losses,
               "dispatch_ms": dispatch_ms,
               "graph_launches": launches, "path": ".orbax resume (graph)"}
    rows = dispatch_rows(mlp[-1], list(dt), summary)

    # --editing_from: the .orbax directory against a .pth of the same arrays
    pth = os.path.join(ORBAX_WORKSPACE, ORBAX_NAME + ".pth")
    extra = {k: meta_want[k] for k in ("density_grid", "density_bitfield")}
    extra.update({k: meta_want[k].item() for k in ("mean_density", "iter_density",
                                                   "mean_count")})
    ckpt_io.write_checkpoint(pth, ckpt_io.checkpoint_state(
        ckpt_io.unflatten(model), int(meta_want["epoch"]),
        int(meta_want["global_step"]), {}, extra=extra))
    pts = []
    for source in (path, pth):
        eopt = parse_args(ORBAX_FLAGS + ["--workspace", os.path.join(
            ORBAX_WORKSPACE, "edit_" + os.path.basename(source)), "--pretrained",
            "--editing_from", source])
        etr = Trainer(eopt, use_checkpoint="scratch", log=lambda *_: None)
        zero_counts()
        pt = ed._get_pt(etr, NeRFDataset(eopt, "train", device=etr.device)
                        .dataloader().item(0), torch.ones(3, device=etr.device))
        counts = read_counts()
        check_launched(counts, (K1_BF16,), "--editing_from pt render")
        pts.append(pt)
    for k in ("pt_rgb_bg", "pt_rgb_fg", "pt_mask", "pt_depth_fg"):
        a, b = pts[0][k], pts[1][k]
        assert torch.isfinite(a).all() and torch.equal(a, b), \
            f"{k}: the pt image from the .orbax differs from the .pth's"
    summary["pt_image_hw"] = list(pts[0]["pt_rgb_fg"].shape[:2])
    summary["pt_render_launches"] = counts
    return summary, rows


def run_host_inputs(card, recorded):
    """Phase 10.  Returns (summary, rows)."""
    t0 = time.time()
    try:
        jp = run_host_jpeg(recorded)
        ob, rows = run_host_orbax()
    finally:
        shutil.rmtree(ORBAX_WORKSPACE, ignore_errors=True)
    wall_s = time.time() - t0
    for label in ("baseline", "progressive", "smoothed"):
        q = jp[label]
        log(f"[host jpeg] {card} | {label}: {q['files']} files, {q['megapixels']:.3f} MP | "
            f"whole file {q['native_s']:.4f} s/MP (host library) vs {q['plain_s']:.4f} "
            f"(plain loops): x{q['whole_speedup']:.1f} | entropy stage "
            f"{q['native_entropy_s']:.4f} vs {q['plain_entropy_s']:.4f} s/MP: "
            f"x{q['entropy_speedup']:.1f}")
    log(f"[host jpeg] every file's coefficients equal the plain loops', every "
        f"decode equals cv2.imdecode (smoothed files: cv2's rows {jp['cv2_row_rule']}; "
        f"unequal pixels under the JAX reader's rule "
        f"{[r['cv2_unequal_pixels'] for r in jp['dropped']]})")
    log(f"[host orbax] {card} | fixture read {ob['read_ms_median']:.2f} ms median of "
        f"{ORBAX_READS}, of which the manifest and B+tree "
        f"{ob['store_open_ms_median']:.2f} ms ({ob['decompressed_bytes']} bytes decompressed, "
        f"{ob['read_mb_per_s']:.1f} MB/s) | --ckpt latest: equal to the .npz bit for bit, "
        f"Adam (count {ob['n_updates']}) to the _opt.npz "
        f"| one dispatch of {GRAPH_K} graphed steps {ob['dispatch_ms']:.1f} ms, losses "
        f"{[round(v, 5) for v in ob['losses']]} | launches {ob['graph_launches']} | "
        f"--editing_from pt image {ob['pt_image_hw']} equal to the .pth's")
    log(f"[host] phase 10 took {wall_s:.1f} s")
    return {"jpeg": jp, "orbax": ob, "wall_s": wall_s}, rows


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--data-axis-worker"]:
        rank, port, ckpt, out = sys.argv[2:6]
        return data_axis_worker(int(rank), port, ckpt, out)
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
        for ws in (QUALITY_ROOT, RECON_WORKSPACE, SD2_WORKSPACE, DATA_AXIS_WORKSPACE,
                   ORBAX_WORKSPACE, ORBAX_SAVE_WORKSPACE):
            shutil.rmtree(ws, ignore_errors=True)


def run_all(card, procs) -> int:
    import torch
    from customnerf_torch.ops import kernels

    import threading
    from customnerf_torch.utils import hostlib
    host_build = {}

    def build_host():
        try:
            t = time.time()
            host_build["so"] = hostlib.build()
            host_build["s"] = time.time() - t
        except BaseException as e:          # re-raised below
            host_build["error"] = e

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    t0 = time.time()
    so = kernels.build()
    kernels.library()
    build_s = time.time() - t0
    log(f"kernels built in {build_s:.1f} s -> {os.path.relpath(so)}")
    host_thread.join()
    if "error" in host_build:
        raise host_build["error"]
    log(f"host library built in {host_build['s']:.1f} s -> "
        f"{os.path.relpath(host_build['so'])}")
    recorded, stop_recording = record_jpeg_decodes()

    from customnerf_torch.engine.measure import captured_calls
    from customnerf_torch.engine.trainer import Trainer
    with captured_calls(Trainer, "train_step", keep=1) as last_step:
        tr, mlp_inputs, dt_calls = run_trainer()
    recon = last_step[-1][0][0]
    tr["f32_dtable"], f32_dt_calls = run_f32_dtable_steps(recon)
    ms = tr["steady_ms_per_step"]
    log(f"[trainer] {card} | {TRAIN_STEPS} steps of {STEP_RAYS} rays | steady "
        f"{ms:.2f} ms/step = {STEP_RAYS / ms * 1e3:.0f} rays/s | slab fill "
        f"{tr['steady_slab_fill']:.3f} | overflowing blocks "
        f"{tr['steady_overflow_frac']:.3f} | budget {tr['budget']} slots/block | "
        f"refresh {statistics.median(tr['refresh_ms']):.1f} ms")
    log(f"[trainer] fixed-view loss {tr['loss_before']:.5f} -> {tr['loss_after']:.5f} "
        f"| launches {tr['launches']} | val view PSNR {tr['psnr_val0']:.2f} dB")
    fd = tr["f32_dtable"]
    log(f"[trainer] {fd['steps']} more steps with mm_bf16 off (the f32 table "
        f"gradient): losses {[round(v, 5) for v in fd['losses']]} | launches "
        f"{fd['launches']}")

    rows = [check_fused_mlp(*args, **kw) for args, kw in
            (mlp_inputs[STEP_SAMPLES], mlp_inputs[REFRESH_QUERIES])]
    rows += dtable_rows(dt_calls)
    for r in rows:
        r["launches"] = tr["launches"][r["name"]]
        r["path"] = "reconstruction"
    f32_rows = dtable_rows(f32_dt_calls)
    for r in f32_rows:
        r["launches"] = fd["launches"][r["name"]]
        r["path"] = "reconstruction, mm_bf16 off"
    rows += f32_rows

    editor, edit_opt, ck = run_checkpoint(recon)
    log(f"[checkpoint] saved {ck['checkpoint']} ({ck['bytes']} bytes); the "
        f"editing trainer's frozen field renders the validation view bit for "
        f"bit; occupancy grid restored")
    tr["dispatch"], flagship_rows = run_flagship_dispatch(ck["checkpoint"])
    rows += flagship_rows
    try:
        tr["orbax"], orbax_rows = run_flagship_orbax(ck["checkpoint"])
    finally:
        shutil.rmtree(ORBAX_SAVE_WORKSPACE, ignore_errors=True)
    rows += orbax_rows
    log_orbax(card, tr["orbax"])
    del recon
    ed, edit_mlp, edit_dt = run_editing(editor, edit_opt)
    med = ed["median_ms"]
    log(f"[full width] SD 1.5 stack, UNet and VAE in {ed['sd_dtype']} (text "
        f"towers f32), parameters {ed['param_counts']}, built on the card in "
        f"{ed['sd_init_s']:.2f} s")
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
            f"{b['peak_flops'] / 1e12:.0f} TFLOP/s, HBM3 3.35 TB/s)")
    prof = ed["profile"]
    log(f"[editing profile] one step: {prof['kernel_ms']:.1f} ms of kernels in a "
        f"{prof['window_ms']:.1f} ms window ({prof['n_kernels']} launches); top: "
        + "; ".join(f"{t['name'][:60]} {t['ms']:.1f} ms x{t['launches']}"
                    for t in prof["top"][:5]))
    edit_rows = [check_fused_mlp(*edit_mlp[0], **edit_mlp[1])]
    edit_rows += dtable_rows(edit_dt)
    for r in edit_rows:
        r["launches"] = ed["launches"][r["name"]]
        r["path"] = "editing"
    rows += edit_rows + ed.pop("dispatch_rows")
    scenes, scene_rows = run_multi_scene(editor, edit_opt)
    log(f"[multi-scene] {card} | S = 2 scenes x 2 prompt pairs, {SCENE_STEPS} steps of "
        f"2 x {STEP_RAYS} rays, per-scene occupancy | {scenes['ms_s2']:.1f} ms/step at "
        f"S = 2, {scenes['ms_s4']:.1f} at S = 4, against {scenes['ms_single']:.1f} a "
        f"single-scene step (x2 {2 * scenes['ms_single']:.1f}, x4 "
        f"{4 * scenes['ms_single']:.1f}) | UNet stage {scenes['unet_ms_s2']:.1f} ms at "
        f"batch 4, {scenes['unet_ms_s4']:.1f} at batch 8, {scenes['unet_ms_single']:.1f} "
        f"at batch 2 | peak {scenes['peak_gb']:.2f} GB | launches {scenes['launches']} "
        f"(a single-scene step {scenes['single_step_launches']}) | against two "
        f"single-scene steps: {scenes['vs_single_rel']:.3g} rel (tol {SCENE_LOSS_RTOL})")
    rows += scene_rows
    for r in scene_rows:            # in the log even if a later phase fails
        log_row(r)
    data_axis, data_rows = run_data_axis(ck["checkpoint"])
    log(f"[data axis] {card} | --mesh_shape data:2, two processes on one card | "
        f"{data_axis['backend'].strip()} | {DATA_AXIS_STEPS} steps of {STEP_RAYS} rays: "
        f"{data_axis['ms_per_step']:.1f} ms/step (one process "
        f"{data_axis['ms_per_step_one_process']:.1f}; not a speed figure: the ranks "
        f"share the card) | losses within {data_axis['loss_rel']:.2g} rel, params max "
        f"{max(q['max_over_lr_steps'] for q in data_axis['params']):.3g} lr-steps, RMS "
        f"{max(q['rms_over_lr_steps'] for q in data_axis['params']):.3g} | view max err "
        f"{data_axis['image_max_err']:.3g}, mean {data_axis['image_mean_err']:.3g} | "
        f"rank 0 launches {data_axis['launches']}")
    rows += data_rows
    for r in data_rows:
        log_row(r)

    guidance, clip_matcher = editor.guidance, editor.clip_matcher
    del editor
    try:
        cdp, cd_mlp, cd_dt = run_image_driven(guidance, clip_matcher, ck["checkpoint"])
    finally:
        shutil.rmtree(CD_WORKSPACE, ignore_errors=True)
    em = cdp["edit"]["median_ms"]
    log(f"[image-driven] {card} | {CD_CONCEPTS} JPEG concept images at 128x128 | "
        f"{cdp['class_images']} DDIM class images (25 steps, 512x512) at "
        f"{cdp['class_s_per_image']:.2f} s each | Custom Diffusion {CD_STEPS} steps, "
        f"batch 2 with prior, {ed['sd_dtype']}: median {cdp['tune_median_step_ms']:.1f} ms/step "
        f"(of which the host's image reads {cdp['tune_host_data_ms_per_step']:.1f}), "
        f"peak {cdp['tune_peak_gb']:.2f} GB, losses {[round(v, 4) for v in cdp['tune_losses']]} "
        f"| resume from checkpoint-{CD_CHECKPOINT}: rel L2 {cdp['resume_rel_l2']:.3g} "
        f"(tol {CD_RESUME_TOL}) | artifacts {cdp['artifact_bytes']} bytes, "
        f"{cdp['adapters']} adapter blocks")
    log(f"[use_cd editing] {card} | {EDIT_STEPS} steps of {STEP_RAYS} rays, "
        f"'a <new1> bear in a forest' | median {em['total']:.1f} ms/step: pt + draws "
        f"{em['pt_and_draws']:.1f}, render to latents {em['render_to_latents']:.1f}, "
        f"UNet {em['unet']:.1f}, backward + Adam {em['backward_adam']:.1f} | peak "
        f"{cdp['edit']['peak_gb']:.2f} GB | eps change with the adapters "
        f"{cdp['eps_max_change_with_adapters']:.3g} | launches {cdp['edit']['launches']}")
    cd_rows = [check_fused_mlp(*cd_mlp[0], **cd_mlp[1])]
    cd_rows += dtable_rows(cd_dt)
    for r in cd_rows:
        r["launches"] = cdp["edit"]["launches"][r["name"]]
        r["path"] = "use_cd editing"
    rows += cd_rows + cdp.pop("dispatch_rows")
    drill = run_drill()
    log(f"[validate_weights] __main__ --validate_weights at full width: exit "
        f"{drill['exit_code']}, ok {drill['ok']}, params {drill['params']}, "
        f"{drill['wall_s']:.1f} s")
    parity, parity_rows = parity_phase(card, guidance, clip_matcher)
    del guidance, clip_matcher
    rows += parity_rows
    try:
        sd2, sd2_rows = run_sd2(ck["checkpoint"])
    finally:
        # the checkpoint (~180 MB with its Adam state) has served its purpose
        for ws in (SD2_WORKSPACE, RECON_WORKSPACE):
            shutil.rmtree(ws, ignore_errors=True)
    rows += sd2_rows
    log_sd2(card, sd2, ed, cdp)

    quality, quality_rows = quality_phase(procs)
    rows += quality_rows
    stop_recording()
    host, host_rows = run_host_inputs(card, recorded)
    rows += host_rows
    for r in rows:
        log_row(r)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "ptxas": kernels.ptxas_log, "kernels": rows, "trainer": tr,
                   "checkpoint": ck, "editing": ed, "multi_scene": scenes,
                   "data_axis": data_axis, "image_driven": cdp,
                   "validate_weights": drill, "parity": parity, "sd2": sd2,
                   "quality": quality, "host_inputs": host,
                   "host_build_s": host_build["s"]},
                  f, indent=1)

    keys = ("name", "path", "shape", "route", "source", "replaces", "launches",
            "max_abs_err", "tolerance", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_peak", "library_ms", "other_mode_ms",
            "live_share")
    missing = {K1, K1_BF16, DT, DT_BF16, GRID, GRID_BWD} - {r["name"] for r in rows}
    assert not missing, f"no row for {missing}"
    log(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
