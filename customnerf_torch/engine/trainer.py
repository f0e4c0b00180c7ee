"""Reconstruction trainer (counterpart of ``customnerf_tpu/engine/trainer.py``,
reconstruction only).

Reference semantics kept:
  * Adam(betas=(0.9, 0.99), eps=1e-15) with the grid table at lr×10
    (main.py:182, network_grid.py:196-206), lr decayed per update as
    ``0.1^min(step/iters, 1)`` (main.py:189-191);
  * NaN gradients zeroed before Adam (the JAX ``optax.zero_nans``);
  * loss = train_rgb·MSE(image) + train_conf·MSE(render_mask)
    (utils_init_nerf.py:224-238);
  * the occupancy grid refreshed every ``update_extra_interval`` steps
    before the step (utils_init_nerf.py:602-607), one step a call;
  * ``render_image`` chunked by ``max_ray_batch`` (renderer.py:1749-1765).

Randomness (march jitter, refresh jitter, ``--batch_rays`` subsets) comes
from one ``torch.Generator`` on the trainer's device seeded from
``opt.seed``; its streams differ from ``jax.random``'s.  Checkpoints,
evaluation strips, test videos, ``--compact_frac -1`` and editing are later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import time

import torch

from customnerf_torch.device import resolve_device
from customnerf_torch.models.field import FieldConfig, NeRFField, param_groups
from customnerf_torch.models.renderer import RenderSettings, render_rays_fast
from customnerf_torch.ops.occupancy import init_state, update_grid
from customnerf_torch.ops.triplane import TriplaneSpec


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item '{item}')")


def build_encoder_spec(opt) -> TriplaneSpec:
    if opt.grid_type != "triplane":
        raise _not_ported(f"--grid_type {opt.grid_type}", "dense path and hash grid")
    chans = [int(c) for c in (opt.triplane_channels
                              if isinstance(opt.triplane_channels, (list, tuple))
                              else [opt.triplane_channels])]
    if len(chans) == 1:
        chans = chans * len(opt.triplane_res)
    return TriplaneSpec(resolutions=tuple(int(r) for r in opt.triplane_res),
                        channels=tuple(chans))


def build_field(opt, device=None) -> NeRFField:
    cfg = FieldConfig(
        bound=opt.bound,
        grid=build_encoder_spec(opt),
        train_conf=bool(opt.train_conf),
        conf_channels=2 if opt.keyword2 is not None else 1,
        detach_mask_from_field=opt.detach_mask_from_field,
        mask_no_dir=opt.mask_no_dir,
        mask_no_dir_nodetach=opt.mask_no_dir_nodetach,
        use_bias=opt.mlp_bias,
    )
    return NeRFField(cfg, seed=opt.seed, device=device)


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


def max_epochs_for(opt, loader_len: int) -> int:
    return int(math.ceil(opt.iters / max(loader_len, 1)))


def psnr(image: torch.Tensor, target: torch.Tensor) -> float:
    mse = float(torch.mean((image - target) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10))


class Trainer:
    def __init__(self, opt, field: NeRFField | None = None, device=None,
                 log=print):
        self.device = resolve_device(device)
        if not opt.cuda_ray:
            raise _not_ported("the dense two-pass path (no -O)",
                              "dense path and hash grid")
        if opt.compact_frac == -1:
            raise _not_ported("--compact_frac -1", "--compact_frac -1 auto-tune")
        if opt.pretrained:
            raise _not_ported("--pretrained (editing)", "editing")
        if opt.mesh_shape:
            raise _not_ported("--mesh_shape", "multi-device")
        self.opt = opt
        self.log = log
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(opt.seed))
        self.field = field if field is not None else build_field(opt, self.device)
        self.settings = render_settings(opt)

        groups = param_groups(self.field)
        self.optimizer = torch.optim.Adam(
            [{"params": groups["grid"], "lr": 10.0 * opt.lr, "lr_scale": 10.0},
             {"params": groups["mlp"], "lr": opt.lr, "lr_scale": 1.0}],
            betas=(0.9, 0.99), eps=1e-15, weight_decay=opt.weight_decay)
        self.n_updates = 0
        self.occ_state = init_state(opt.cascade, grid_size=opt.occ_grid_size,
                                    device=self.device)
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": []}
        n_params = sum(p.numel() for p in self.field.parameters())
        self.log(f"[INFO] Trainer | {self.device} | fp32 | #parameters: {n_params}")

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
               bg_color=None):
        """The -O fast path: training marches 2× the kept samples; eval
        marches at the reference's inference budget (max_steps candidates)
        or ``--eval_march_candidates``."""
        opt = self.opt
        n_total = max(opt.num_steps + opt.upsample_steps, 2)
        n_eval = int(opt.eval_march_candidates) or max(opt.max_steps, n_total * 2)
        n_coarse = n_total * 2 if train else max(n_eval, n_total * 2)
        return render_rays_fast(
            self.field, rays_o, rays_d, self.occ_state, self.settings,
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

    def train_step(self, batch, perturb: bool = True):
        """One reconstruction step: render, loss, backward, NaN-zeroing,
        Adam.  Returns (loss, aux, render stats) as device tensors."""
        rays_o, rays_d = batch.rays_o, batch.rays_d
        rgbs = batch.rgbs.reshape(-1, 3)
        mask = batch.mask.reshape(-1)
        if self.opt.batch_rays:
            n = rays_o.shape[0]
            sel = torch.randperm(n, generator=self.generator,
                                 device=self.device)[:int(self.opt.batch_rays)]
            rgbs, mask, rays_o, rays_d = rgbs[sel], mask[sel], rays_o[sel], rays_d[sel]

        out = self.render(rays_o, rays_d, train=True, perturb=perturb)
        loss, aux = self.loss(out, rgbs, mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        base = self.lr_at(self.n_updates)
        for group in self.optimizer.param_groups:
            group["lr"] = group["lr_scale"] * base
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.masked_fill_(torch.isnan(p.grad), 0.0)
        self.optimizer.step()
        self.n_updates += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, out["stats"]

    # ---------------------------------------------------------- train loop
    def train_one_epoch(self, loader):
        self.log(f"==> Start Training Epoch {self.epoch}, "
                 f"lr={self.lr_at(self.n_updates):.6f} ...")
        losses = []
        for batch in loader:
            if self.global_step % self.opt.update_extra_interval == 0:
                self.update_extra_state()
            self.global_step += 1
            loss, _, _ = self.train_step(batch)
            losses.append(loss)
        avg = float(torch.stack(losses).mean()) if losses else 0.0
        self.stats["loss"].append(avg)
        self.log(f"==> Finished Epoch {self.epoch}. average_loss {avg}")
        return avg

    def train(self, train_loader, max_epochs: int):
        t0 = time.time()
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_loader)
        self.log(f"[INFO] training takes {(time.time() - t0) / 60:.4f} minutes.")

    # -------------------------------------------------------------- render
    @torch.no_grad()
    def render_image(self, rays_o, rays_d, perturb: bool = False,
                     bg_color=None):
        """Full-frame render, chunked over ``max_ray_batch`` rays.  The tail
        is edge-padded to a whole chunk, as in the JAX version, so every
        chunk marches and compacts the same number of rays."""
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
                              train=False, perturb=perturb, bg_color=bg_color)
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
    def evaluate(self, loader, max_images: int = 4):
        """Render up to ``max_images`` views and log their PSNR (the
        evaluation strips are later work).  Returns the mean PSNR."""
        psnrs = []
        for i, batch in enumerate(loader):
            if i >= max_images:
                break
            out = self.render_image(batch.rays_o, batch.rays_d)
            psnrs.append(psnr(out["image"], batch.rgbs.reshape(-1, 3)))
        mean = sum(psnrs) / max(len(psnrs), 1)
        self.log(f"++> eval PSNR: {mean:.2f} dB ({[round(p, 2) for p in psnrs]})")
        return mean
