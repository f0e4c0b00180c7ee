"""Trainer: reconstruction and single-scene LGIE editing, checkpoints
(counterpart of ``customnerf_tpu/engine/trainer.py``).

Reference semantics kept:
  * Adam(betas=(0.9, 0.99), eps=1e-15) with the grid table at lr×10
    (main.py:182, network_grid.py:196-206), lr decayed per update as
    ``0.1^min(step/iters, 1)`` (main.py:189-191);
  * NaN gradients zeroed before Adam (the JAX ``optax.zero_nans``);
  * loss = train_rgb·MSE(image) + train_conf·MSE(render_mask)
    (utils_init_nerf.py:224-238);
  * ``-O`` renders through the occupancy grid (``render_rays_fast``),
    refreshed every ``update_extra_interval`` steps before the step
    (utils_init_nerf.py:602-607); without it (``-O2``) the dense two-pass
    ``render_rays`` runs and there is no occupancy state to refresh, save
    or restore (JAX ``trainer.py:188-193, 940-953, 1028``); one step a call;
  * ``--compact_frac -1``: compaction stays off until the grid has left its
    warm-up, then the measured slab fill sets the fraction once
    (``_autotune_compaction``, JAX ``trainer.py:507-572``);
  * ``render_image`` chunked by ``max_ray_batch`` (renderer.py:1749-1765);
  * checkpoints (``engine/checkpoint.py``): saved before training and
    around each ``eval_interval`` (utils_init_nerf.py:492-506), the
    ``--ckpt`` policy scratch|latest|latest_model|<path> and
    ``--editing_from`` (utils_init_nerf.py:136-150); every load restores the
    occupancy grid, ``model_only`` ones too;
  * editing (``--pretrained``): a frozen copy of the field loaded from
    ``--editing_from``, the pt-render cache, and ``train_step`` dispatching
    to ``engine/editing.py::editing_step``; refreshes keep their cadence.

The grid field starts from the JAX package's initial parameters for
``opt.seed`` (``utils/threefry.py``), the tri-plane field from a
``torch.Generator`` seeded with it (``models/field.py``).  Randomness during training (march
and depth jitter, ``sample_pdf``'s u, refresh jitter, ``--batch_rays``
subsets, the editing bg colour, t and noises) comes from one
``torch.Generator`` on the trainer's device seeded from ``opt.seed``; its
streams differ from ``jax.random``'s.  The LGIE gate draws from
``numpy.random.RandomState(opt.seed)`` as the JAX trainer does.  The JAX
package rematerialises the compacted evaluation under editing for a TPU's
memory; the port does not.

Evaluation writes the strip ``gt | rgb | depth [| gt_mask | pred_mask | fg
| bg]`` (``utils/png.py``) and keeps the best result's checkpoint as
``{name}.pth``; ``test`` writes one PNG a pose and, where ``cv2`` is
installed, the mp4 (without it, the warning the JAX package logs when its
writer fails); ``--clip_metrics`` scores the test renders with CLIP.
``--profile`` traces the first epoch with ``torch.profiler`` (Chrome trace
under ``{workspace}/profile/``, where the JAX trainer writes its trace).
Multi-scene and K-step editing, ``--mesh_shape`` and ``.orbax`` are later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time

import numpy as np
import torch

from customnerf_torch.device import resolve_device
from customnerf_torch.engine import checkpoint as ckpt_io
from customnerf_torch.engine.convert import params_from_flax, params_to_flax
from customnerf_torch.engine.editing import editing_step
from customnerf_torch.models.field import FieldConfig, NeRFField, param_groups
from customnerf_torch.models.renderer import (RenderSettings, render_rays,
                                              render_rays_fast)
from customnerf_torch.ops.grid import GridSpec
from customnerf_torch.ops.occupancy import (WARMUP_UPDATES, OccupancyState,
                                            init_state, march_rays_occupancy,
                                            packbits, update_grid)
from customnerf_torch.ops.ray import near_far_from_aabb
from customnerf_torch.ops.triplane import TriplaneSpec
from customnerf_torch.utils import png


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item '{item}')")


def build_encoder_spec(opt) -> GridSpec | TriplaneSpec:
    """The tiled / hash grid (the reference field) or the tri-plane, whose
    table gradient keeps the JAX package's bf16 operands (``mm_bf16``) and
    whose forward gathers bf16 rows under ``--triplane_fwd_bf16``
    (``trainer.py:80-95``)."""
    if opt.grid_type != "triplane":
        return GridSpec(input_dim=3, num_levels=opt.grid_levels,
                        level_dim=opt.grid_level_dim,
                        base_resolution=opt.grid_base_resolution,
                        log2_hashmap_size=opt.log2_hashmap_size,
                        desired_resolution=opt.desired_resolution,
                        gridtype=opt.grid_type)
    chans = [int(c) for c in (opt.triplane_channels
                              if isinstance(opt.triplane_channels, (list, tuple))
                              else [opt.triplane_channels])]
    if len(chans) == 1:
        chans = chans * len(opt.triplane_res)
    return TriplaneSpec(resolutions=tuple(int(r) for r in opt.triplane_res),
                        channels=tuple(chans),
                        fwd_bf16=bool(opt.triplane_fwd_bf16))


def field_config(opt) -> FieldConfig:
    """The field of ``trainer.py:106-119``: bf16 heads under ``fp16``
    (``-O``, ``-O2``, ``--fp16``), run by the fused kernel's bf16 mode with
    ``--backend xla`` and by its f32 mode with ``--backend pallas``."""
    return FieldConfig(
        bound=opt.bound,
        grid=build_encoder_spec(opt),
        train_conf=bool(opt.train_conf),
        conf_channels=2 if opt.keyword2 is not None else 1,
        detach_mask_from_field=opt.detach_mask_from_field,
        mask_no_dir=opt.mask_no_dir,
        mask_no_dir_nodetach=opt.mask_no_dir_nodetach,
        use_bias=opt.mlp_bias,
        compute_dtype="bfloat16" if opt.fp16 else "float32",
        backend=opt.backend,
    )


def build_field(opt, device=None) -> NeRFField:
    return NeRFField(field_config(opt), seed=opt.seed, device=device)


def render_settings(opt) -> RenderSettings:
    return RenderSettings(
        bound=opt.bound,
        min_near=opt.min_near,
        num_steps=opt.num_steps,
        upsample_steps=opt.upsample_steps,
        train_conf=bool(opt.train_conf),
        soft_mask=opt.soft_mask,
        conf_thr=opt.conf_thr,
        detach_bg=opt.detach_bg,
        detach_mask_from_field=opt.detach_mask_from_field,
    )


def compaction_frac(fill: float, compact_block: int, n_total: int) -> float:
    """``--compact_frac`` from a measured slab fill (JAX
    ``trainer.py:552-566``): 1.3× headroom over the mean, off above 60 %
    (a dense slab gains nothing), and the per-block budget snapped to the
    nearest 128 slots but never under 1.1× the fill."""
    frac = 0.0 if fill > 0.6 else float(min(1.0, max(0.05, fill * 1.3)))
    if frac > 0.0:
        gk = compact_block * n_total
        snapped = max(128, int(round(frac * gk / 128.0)) * 128)
        if snapped < fill * 1.1 * gk:
            snapped = max(128, -(-int(np.ceil(frac * gk)) // 128) * 128)
        frac = float(min(1.0, snapped / gk))
    return frac


def max_epochs_for(opt, loader_len: int) -> int:
    return int(math.ceil(opt.iters / max(loader_len, 1)))


def psnr(image: torch.Tensor, target: torch.Tensor) -> float:
    mse = float(torch.mean((image - target) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10))


class Trainer:
    name = "df"          # checkpoint files are {name}_ep{epoch:04d}.pth

    def __init__(self, opt, field: NeRFField | None = None, device=None,
                 log=print, guidance=None, use_checkpoint: str | None = None):
        self.device = resolve_device(device)
        if opt.mesh_shape:
            raise _not_ported("--mesh_shape", "multi-device")
        if opt.ckpt_format != "pth":
            raise _not_ported(f"--ckpt_format {opt.ckpt_format}", ".orbax")
        self.opt = opt
        self.log = log
        self.guidance = guidance
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(opt.seed))
        self.np_rng = np.random.RandomState(opt.seed)   # the LGIE gate
        self.field = field if field is not None else build_field(opt, self.device)
        self.settings = render_settings(opt)
        self.ckpt_path = os.path.join(opt.workspace, "checkpoints")

        groups = param_groups(self.field)
        self.optimizer = torch.optim.Adam(
            [{"params": groups["grid"], "lr": 10.0 * opt.lr, "lr_scale": 10.0},
             {"params": groups["mlp"], "lr": opt.lr, "lr_scale": 1.0}],
            betas=(0.9, 0.99), eps=1e-15, weight_decay=opt.weight_decay)
        self.n_updates = 0
        self.occ_state = None        # the -O occupancy grid; -O2 has none
        if opt.cuda_ray:
            self.occ_state = init_state(opt.cascade, grid_size=opt.occ_grid_size,
                                        device=self.device)
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [],
                      "checkpoints": [], "best_result": None}
        self.pt_dict = {}        # editing: frozen-model renders per img_path
        n_params = sum(p.numel() for p in self.field.parameters())
        self.log(f"[INFO] Trainer | {self.device} | {'bf16' if opt.fp16 else 'fp32'} "
                 f"| #parameters: {n_params}")

        # checkpoint policy (utils_init_nerf.py:136-150)
        policy = use_checkpoint if use_checkpoint is not None else opt.use_ckpt
        if opt.editing_from:
            self.log(f"[INFO] Loading {opt.editing_from} ...")
            self._load(opt.editing_from, model_only=True)
        if policy == "scratch":
            self.log("[INFO] Training from scratch ...")
        elif policy in ("latest", "latest_model"):
            path = ckpt_io.latest_checkpoint(self.ckpt_path)
            if path:
                self.log(f"[INFO] Latest checkpoint is {path}")
                self._load(path, model_only=policy == "latest_model")
            else:
                self.log("[WARN] No checkpoint found, model randomly initialized.")
        else:
            self.log(f"[INFO] Loading {policy} ...")
            self._load(policy)

        # editing: a frozen copy of the pretrained field (trainer.py:237-248)
        self.field_pretrained = self.field
        if opt.pretrained:
            source = opt.editing_from or opt.use_ckpt
            if source and os.path.exists(str(source)):
                params, _ = ckpt_io.load_checkpoint(
                    source, conf_channels=self.field.cfg.conf_channels)
                frozen = build_field(opt, self.device)
                frozen.load_state_dict(params_from_flax(params))
            else:
                frozen = copy.deepcopy(self.field)
            self.field_pretrained = frozen.requires_grad_(False)
            self.log("[INFO] loaded pretrained (frozen) model.")

    # ------------------------------------------------------------ schedule
    def lr_at(self, count: int) -> float:
        """Base lr of the ``count``-th update (0-based), per-step decay."""
        return self.opt.lr * 0.1 ** min(count / self.opt.iters, 1.0)

    # --------------------------------------------------- occupancy refresh
    def update_extra_state(self):
        """Refresh the occupancy grid (reference renderer.py:1659-1717)."""
        self.occ_state = update_grid(self.occ_state, self.field.density,
                                     self.opt.bound, self.opt.density_thresh,
                                     generator=self.generator)

    # -------------------------------------------------------------- render
    def render(self, rays_o, rays_d, train: bool, perturb: bool,
               bg_color=None, field=None, mark=None):
        """``-O2``: the dense two-pass ``render_rays``.  ``-O``: the fast
        path; training marches 2× the kept samples, eval marches at the
        reference's inference budget (max_steps candidates) or
        ``--eval_march_candidates``.  ``field`` defaults to the trained
        one; ``mark`` is ``render_rays``' stage callback."""
        opt = self.opt
        field = field if field is not None else self.field
        if not opt.cuda_ray:
            return render_rays(field, rays_o, rays_d, self.settings, train=train,
                               perturb=perturb, generator=self.generator,
                               bg_color=bg_color, mark=mark)
        n_total = max(opt.num_steps + opt.upsample_steps, 2)
        n_eval = int(opt.eval_march_candidates) or max(opt.max_steps, n_total * 2)
        n_coarse = n_total * 2 if train else max(n_eval, n_total * 2)
        return render_rays_fast(
            field, rays_o, rays_d, self.occ_state, self.settings,
            n_coarse=n_coarse, n_keep=n_total, perturb=perturb,
            generator=self.generator, bg_color=bg_color,
            compact_frac=max(opt.compact_frac, 0.0),
            compact_block=opt.compact_block)

    # ---------------------------------------------------------- train step
    def loss(self, out, rgbs, mask):
        opt = self.opt
        loss_c = opt.train_rgb * torch.mean((out["image"] - rgbs) ** 2)
        aux = {"loss_c": loss_c}
        loss = loss_c
        if opt.train_conf:
            loss_m = opt.train_conf * torch.mean(
                (out["render_mask"][..., 0] - mask) ** 2)
            loss = loss + loss_m
            aux["loss_m"] = loss_m
        return loss, aux

    def apply_gradients(self, loss, mark=None):
        """Backward, NaN-zeroing, the decayed lr, one Adam update;
        ``mark(name)`` after the ``backward`` and the ``adam`` update."""
        mark = mark or (lambda _: None)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        base = self.lr_at(self.n_updates)
        for group in self.optimizer.param_groups:
            group["lr"] = group["lr_scale"] * base
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.masked_fill_(torch.isnan(p.grad), 0.0)
        self.optimizer.step()
        mark("adam")
        self.n_updates += 1

    def train_step(self, batch, perturb: bool = True, mark=None):
        """One reconstruction step (render, loss, backward, NaN-zeroing,
        Adam), or under ``--pretrained`` one editing step.  ``mark(name)``
        is called at the stage boundaries: the dense render's, ``loss``,
        ``backward`` and ``adam``, or the editing step's.  Returns (loss,
        aux, render stats) as device tensors."""
        if self.opt.pretrained:
            return editing_step(self, batch, perturb=perturb, mark=mark)
        rays_o, rays_d = batch.rays_o, batch.rays_d
        rgbs = batch.rgbs.reshape(-1, 3)
        mask = batch.mask.reshape(-1)
        if self.opt.batch_rays:
            n = rays_o.shape[0]
            sel = torch.randperm(n, generator=self.generator,
                                 device=self.device)[:int(self.opt.batch_rays)]
            rgbs, mask, rays_o, rays_d = rgbs[sel], mask[sel], rays_o[sel], rays_d[sel]

        out = self.render(rays_o, rays_d, train=True, perturb=perturb, mark=mark)
        loss, aux = self.loss(out, rgbs, mask)
        if mark:
            mark("loss")
        self.apply_gradients(loss, mark=mark)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, out["stats"]

    # ------------------------------------------------ compaction auto-tune
    def measure_slab_fill(self, batch) -> float:
        """Mean share of live slots in the fast path's [N, n_keep] slab for
        one batch, marched as a training step marches."""
        opt = self.opt
        n_total = max(opt.num_steps + opt.upsample_steps, 2)
        o, d = batch.rays_o, batch.rays_d
        aabb = torch.tensor([-opt.bound] * 3 + [opt.bound] * 3,
                            dtype=torch.float32, device=o.device)
        with torch.no_grad():
            nears, fars = near_far_from_aabb(o, d, aabb, opt.min_near)
            miss = nears >= fars
            _, valid, _ = march_rays_occupancy(
                self.occ_state, o, d, torch.where(miss, 0.0, nears),
                torch.where(miss, 1.0, fars), opt.bound, n_coarse=n_total * 2,
                n_keep=n_total, perturb=True, generator=self.generator)
            return float((valid & ~miss[:, None]).float().mean())

    def _autotune_compaction(self, loader):
        """``--compact_frac -1``: once the occupancy grid has left its
        warm-up, measure the slab fill on the first batch and fix
        ``--compact_frac`` from it (``compaction_frac``); until then
        compaction stays off.  Without an occupancy grid it is off."""
        if self.occ_state is None:
            self.opt.compact_frac = 0.0
            return
        if self.occ_state.iter_density <= WARMUP_UPDATES:
            return
        batch = loader.item(0) if hasattr(loader, "item") else next(iter(loader))
        fill = self.measure_slab_fill(batch)
        n_total = max(self.opt.num_steps + self.opt.upsample_steps, 2)
        frac = compaction_frac(fill, self.opt.compact_block, n_total)
        self.log(f"[INFO] compaction auto-tune: measured slab fill "
                 f"{fill:.3f} → --compact_frac {frac:.3f}")
        self.opt.compact_frac = frac

    # ---------------------------------------------------------- train loop
    def train_one_epoch(self, loader):
        if self.opt.cuda_ray and self.opt.compact_frac == -1:
            self._autotune_compaction(loader)
        self.log(f"==> Start Training Epoch {self.epoch}, "
                 f"lr={self.lr_at(self.n_updates):.6f} ...")
        losses = []
        for batch in loader:
            if (self.opt.cuda_ray
                    and self.global_step % self.opt.update_extra_interval == 0):
                self.update_extra_state()
            self.global_step += 1
            loss, _, _ = self.train_step(batch)
            losses.append(loss)
        avg = float(torch.stack(losses).mean()) if losses else 0.0
        self.stats["loss"].append(avg)
        self.log(f"==> Finished Epoch {self.epoch}. average_loss {avg}")
        return avg

    def train(self, train_loader, max_epochs: int, valid_loader=None):
        """Epochs up to ``max_epochs``, saving a full checkpoint first and
        before and after each ``eval_interval``'s evaluation
        (utils_init_nerf.py:492-506)."""
        t0 = time.time()
        self.save_checkpoint()
        prof = self._start_profile() if self.opt.profile else None
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_loader)
            if prof is not None:
                self._stop_profile(prof)
                prof = None
            if epoch % self.opt.eval_interval == 0:
                self.save_checkpoint()
                if valid_loader is not None:
                    self.evaluate_one_epoch(valid_loader)
                self.save_checkpoint()
        self.log(f"[INFO] training takes {(time.time() - t0) / 60:.4f} minutes.")

    def _start_profile(self):
        """``--profile``: a ``torch.profiler`` trace of the first epoch (the
        JAX trainer's xplane trace, trainer.py:484-497)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.opt.workspace, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_ep{self.epoch:04d}.json")
        prof.export_chrome_trace(path)
        self.log(f"[INFO] --profile: epoch {self.epoch} traced to {path}")
        self.opt.profile = False

    # ---------------------------------------------------------- checkpoints
    def _occ_extra(self):
        """The occupancy grid, which checkpoint-driven renders must march
        (a fresh grid cost 3.6 dB on bear eval frames, trainer.py:939-953);
        None without one."""
        occ = self.occ_state
        if occ is None:
            return None
        return {"mean_density": float(occ.mean_density), "mean_count": 0,
                "density_grid": occ.density_grid.detach().cpu().numpy(),
                "density_bitfield": occ.bitfield.detach().cpu().numpy(),
                "iter_density": int(occ.iter_density)}

    def save_checkpoint(self):
        """A full checkpoint (with the Adam state) of this epoch into the
        ring; returns its path."""
        file_name = f"{self.name}_ep{self.epoch:04d}.pth"
        self.stats["checkpoints"].append(file_name)
        ckpt_io.prune_ring(self.stats, self.ckpt_path, self.opt.max_keep_ckpt)
        optim = {"state_dict": self.optimizer.state_dict(),
                 "n_updates": self.n_updates}
        return ckpt_io.save_checkpoint(
            os.path.join(self.ckpt_path, file_name),
            params_to_flax(self.field.state_dict()), self.epoch,
            self.global_step, self.stats, optimizer_state=optim,
            extra=self._occ_extra())

    def _load(self, path, model_only: bool = False):
        if not path or not os.path.exists(str(path)):
            self.log(f"[WARN] checkpoint {path} not found.")
            return
        params, meta = ckpt_io.load_checkpoint(
            str(path), conf_channels=self.field.cfg.conf_channels)
        self.field.load_state_dict(params_from_flax(params))
        self.log("[INFO] loaded model.")
        # the occupancy grid is model state in the reference: restored on
        # model_only loads too (--editing_from, latest_model)
        if meta:
            self._restore_occ_state(meta)
        if model_only or not meta:
            return
        self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        if meta.get("stats"):
            self.stats = meta["stats"]
        optim = meta.get(ckpt_io.TORCH_OPTIMIZER_KEY)
        if optim is not None:
            self.optimizer.load_state_dict(optim["state_dict"])
            self.n_updates = int(optim["n_updates"])
            self.log("[INFO] loaded optimizer.")
        self.log(f"[INFO] load at epoch {self.epoch}, global step {self.global_step}")

    def _restore_occ_state(self, meta):
        """The occupancy state from checkpoint meta (trainer.py:1023-1050),
        under ``-O`` only."""
        if not self.opt.cuda_ray or meta.get("density_grid") is None:
            return
        g = self.opt.occ_grid_size
        grid = torch.tensor(np.asarray(meta["density_grid"], np.float32),
                            device=self.device)
        if tuple(grid.shape) != (self.opt.cascade, g ** 3):
            self.log(f"[WARN] checkpoint density_grid shape {tuple(grid.shape)} "
                     f"!= configured {(self.opt.cascade, g ** 3)}; keeping "
                     f"the fresh grid.")
            return
        mean_density = torch.tensor(float(meta.get("mean_density", 0.0)),
                                    dtype=torch.float32, device=self.device)
        bitfield = meta.get("density_bitfield")
        if bitfield is not None:
            bitfield = torch.tensor(np.asarray(bitfield, np.uint8), device=self.device)
        else:
            bitfield = packbits(grid, torch.clamp(mean_density,
                                                  max=self.opt.density_thresh))
        self.occ_state = OccupancyState(
            density_grid=grid, bitfield=bitfield, mean_density=mean_density,
            iter_density=int(meta.get("iter_density", 16)), grid_size=g)
        self.log("[INFO] restored occupancy grid from checkpoint.")

    # -------------------------------------------------------------- render
    @torch.no_grad()
    def render_image(self, rays_o, rays_d, perturb: bool = False,
                     bg_color=None, field=None):
        """Full-frame render of ``field`` (default: the trained one), chunked
        over ``max_ray_batch`` rays.  The tail is edge-padded to a whole
        chunk, as in the JAX version, so every chunk marches and compacts the
        same number of rays."""
        chunk = int(self.opt.max_ray_batch)
        N = rays_o.shape[0]
        pad = (-N) % chunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o[-1:].expand(pad, 3)])
            rays_d = torch.cat([rays_d, rays_d[-1:].expand(pad, 3)])
        if bg_color is not None:
            bg_color = torch.as_tensor(bg_color, dtype=torch.float32,
                                       device=rays_o.device)
        parts = []
        for i in range(0, N + pad, chunk):
            out = self.render(rays_o[i:i + chunk], rays_d[i:i + chunk],
                              train=False, perturb=perturb, bg_color=bg_color,
                              field=field)
            keep = {k: out[k] for k in ("image", "depth", "weights_sum",
                                        "render_mask") if k in out}
            for side in ("fg", "bg"):
                if side in out:
                    keep[side] = {k: out[side][k]
                                  for k in ("image", "depth", "weights_sum")}
            parts.append(keep)

        def merge(key, sub=None):
            xs = [p[key] if sub is None else p[key][sub] for p in parts]
            return torch.cat(xs)[:N]

        merged = {}
        for k, v in parts[0].items():
            merged[k] = ({s: merge(k, s) for s in v} if isinstance(v, dict)
                         else merge(k))
        return merged

    @torch.no_grad()
    def evaluate_one_epoch(self, loader, name=None):
        """Render up to four views (all with ``--val_all_images``), write
        their strips and log their PSNR; the best mean PSNR so far saves
        ``{name}.pth`` with the occupancy grid (utils_init_nerf.py:745-752,
        817-833).  Returns the per-view PSNRs."""
        opt = self.opt
        self.log(f"++> Evaluate {opt.workspace} at epoch {self.epoch} ...")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        strips, psnrs = [], []
        for i, batch in enumerate(loader):
            if not opt.val_all_images and i >= 4:
                break
            H, W = batch.H, batch.W
            out = self.render_image(batch.rays_o, batch.rays_d)
            gt = batch.rgbs.reshape(H, W, 3)
            rgb = out["image"].reshape(H, W, 3)
            psnrs.append(psnr(rgb, gt))
            ims = [gt, rgb, out["depth"].reshape(H, W, 1).expand(H, W, 3)]
            if opt.train_conf and "render_mask" in out:
                gt_mask = batch.mask.reshape(H, W, 1).expand(H, W, 3)
                pm = out["render_mask"].reshape(H, W, -1)
                ims += [gt_mask, pm.mean(-1, keepdim=True).expand(H, W, 3),
                        out["fg"]["image"].reshape(H, W, 3),
                        out["bg"]["image"].reshape(H, W, 3)]
            strip = torch.cat(ims, dim=1).cpu().numpy()
            if opt.val_all_images:
                _write_png(os.path.join(opt.workspace, "validation_all",
                                        f"{i + 1}.png"), strip)
            else:
                strips.append(strip)
        if strips:
            path = os.path.join(opt.workspace, "validation", f"{name}.png")
            _write_png(path, np.concatenate(strips, axis=0))
            self.log(f"++> saved validation strip to {path}")
        mean_psnr = float(np.mean(psnrs)) if psnrs else 0.0
        self.log(f"++> eval PSNR: {mean_psnr:.2f} dB "
                 f"({[round(p, 2) for p in psnrs]})")
        self.stats["valid_loss"].append(-mean_psnr)
        self.stats["results"].append(-mean_psnr)

        # the best checkpoint ('min' over results, i.e. max PSNR) is the one
        # --test points at: it carries the occupancy grid too
        best = self.stats.get("best_result")
        if best is None or self.stats["results"][-1] < best:
            self.log(f"[INFO] New best result: {best} --> "
                     f"{self.stats['results'][-1]}")
            self.stats["best_result"] = self.stats["results"][-1]
            ckpt_io.save_checkpoint(
                os.path.join(self.ckpt_path, f"{self.name}.pth"),
                params_to_flax(self.field.state_dict()), self.epoch,
                self.global_step, self.stats, extra=self._occ_extra())
        return psnrs

    # ---------------------------------------------------------------- test
    @torch.no_grad()
    def test(self, loader, save_path=None, name=None, write_video=True,
             split=None):
        """One PNG a pose under ``{save_path}/{name}/`` — beside the frozen
        pretrained render under ``--pretrained``, with the mask / fg / bg
        columns under ``--render_all`` — then the mp4 and, with
        ``--clip_metrics``, the CLIP scores (utils_init_nerf.py:520-569).
        Returns the frames' paths."""
        opt = self.opt
        save_path = save_path or os.path.join(opt.workspace, "results")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        if split:
            name = f"{name}_{split}"
        os.makedirs(os.path.join(save_path, name), exist_ok=True)
        self.log(f"==> Start Test, save results to {save_path}")
        side_by_side = opt.pretrained and self.field_pretrained is not self.field
        frames, paths, clip_after, clip_before = [], [], [], []
        for i, batch in enumerate(loader):
            H, W = batch.H, batch.W
            out = self.render_image(batch.rays_o, batch.rays_d)
            pred = out["image"].reshape(H, W, 3)
            if opt.clip_metrics:
                clip_after.append(pred.cpu().numpy())
            if side_by_side:
                pt = self.render_image(batch.rays_o, batch.rays_d,
                                       field=self.field_pretrained)
                pt = pt["image"].reshape(H, W, 3)
                if opt.clip_metrics:
                    clip_before.append(pt.cpu().numpy())
                pred = torch.cat([pred, pt], dim=1)
            if opt.train_conf and opt.render_all and "render_mask" in out:
                pm = out["render_mask"].reshape(H, W, -1)
                pred = torch.cat([pred, pm.mean(-1, keepdim=True).expand(H, W, 3),
                                  out["fg"]["image"].reshape(H, W, 3),
                                  out["bg"]["image"].reshape(H, W, 3)], dim=1)
            path = os.path.join(save_path, name, f"{i:03d}.png")
            frames.append(_write_png(path, pred.cpu().numpy()))
            paths.append(path)

        if write_video and frames:
            video_path = os.path.join(save_path, f"{name}_rgb.mp4")
            try:
                import cv2
                h, w = frames[0].shape[:2]
                vw = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     30, (w, h))
                for frame in frames:
                    vw.write(np.ascontiguousarray(frame[..., ::-1]))
                vw.release()
            except Exception as e:
                self.log(f"[WARN] mp4 write failed ({e}); PNGs saved.")
        if opt.clip_metrics and clip_after:
            self.report_clip_metrics(np.stack(clip_after),
                                     np.stack(clip_before) if clip_before else None,
                                     save_path, name)
        self.log("==> Finished Test.")
        return paths

    def report_clip_metrics(self, after, before, save_path, name):
        """CLIP score of the test renders ``after`` [B, H, W, 3] against
        ``--text``, and with the frozen renders ``before`` and
        ``--clip_ref_text`` the directional score; written to
        ``{save_path}/{name}_clip_metrics.json``."""
        from customnerf_torch.guidance.clip_view import (
            CLIPViewMatcher, clip_directional_score, clip_score)

        opt = self.opt
        matcher = getattr(self, "clip_matcher", None)
        if matcher is None:
            if not opt.clip_weights and not opt.allow_random_guidance:
                self.log(
                    "[WARN] --clip_metrics without --clip_weights: scores "
                    "from a RANDOM CLIP are meaningless. Provide "
                    "--clip_weights (or force with --allow_random_guidance). "
                    "Skipping.")
                return None
            matcher = CLIPViewMatcher(weights_dir=opt.clip_weights,
                                      device=self.device)
            self.clip_matcher = matcher

        metrics = {"clip_score": clip_score(matcher, after, opt.text),
                   "text": opt.text, "n_views": int(len(after))}
        if before is not None and opt.clip_ref_text:
            metrics["clip_directional"] = clip_directional_score(
                matcher, before, after, opt.clip_ref_text, opt.text)
            metrics["ref_text"] = opt.clip_ref_text
        elif before is not None:
            self.log("[WARN] --clip_metrics: no --clip_ref_text given; "
                     "skipping the directional score.")
        line = " ".join(f"{k}={v:.4f}" for k, v in metrics.items()
                        if isinstance(v, float))
        self.log(f"==> CLIP metrics [{name}]: {line}")
        path = os.path.join(save_path, f"{name}_clip_metrics.json")
        with open(path, "w") as f:
            json.dump(metrics, f, indent=1)
        self.log(f"==> wrote {path}")
        return metrics


def _write_png(path: str, image: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0, 1] → an 8-bit RGB PNG; returns the pixels."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pixels = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    png.write(path, pixels)
    return pixels
