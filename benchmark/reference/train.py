"""The reference's first training steps of a cell, from the inputs that
``benchmark/lib/inputs.py`` makes for the seed: what the program's first
steps must agree with.

``recon_readings`` and ``edit_readings`` return each step's loss, each
parameter's first gradient as Adam takes it (from Adam's first moment
after one update) and the norm of each parameter's change after the first
and after the last checked step.  The render takes the configuration's
path (``benchmark/lib/recipe.py``: ``-O`` or ``-O2``).  The steps are the
port's (``engine/trainer.py``, ``engine/editing.py``): Adam(0.9,
0.99, eps 1e-15) with the encoder table at lr×10 and the lr decayed as
``0.1^(update/iters)``, NaN gradients zeroed; reconstruction takes
train_rgb·MSE(image) + train_conf·MSE(mask); editing takes the LGIE pre-pass
(random bg colour, the frozen field's render of a view the first time it
appears, the gate from ``RandomState(seed)``, t) and
Σ latents·SDS cotangent + keep_bg·L1(pt bg, bg), the cotangent from the
UNet's text-anchored CFG at 512² latents.  Every matmul and convolution
runs in f32 with TF32 off, unless ``Precision`` (the control) says less.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib import inputs, recipe
from benchmark.lib.recipe import encoder_spec
from benchmark.reference import nerf, sd


@contextlib.contextmanager
def no_tf32():
    held = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held


def head_shapes(cfg, spec) -> dict:
    """The seven bias-free 64-wide heads, [out, in] (the port's names):
    27 view features (3 + 3·2·4 frequencies), 3 colours and 1 confidence."""
    h, view = 64, 27
    return {"feature_net.hidden_0.weight": (h, spec.output_dim),
            "feature_net.hidden_1.weight": (h, h), "feature_net.out.weight": (h, h),
            "density_net.hidden_0.weight": (h, h), "density_net.out.weight": (1, h),
            "rgb_net.hidden_0.weight": (h, view + h), "rgb_net.out.weight": (4, h)}


def initial_field(cfg, seed, device) -> dict:
    spec = encoder_spec(cfg)
    table = (spec.table_size, spec.max_channels if isinstance(spec, nerf.TriplaneSpec)
             else spec.level_dim)
    return inputs.field_weights(seed, table, head_shapes(cfg, spec), device)


def _adam(params: dict, cfg):
    return torch.optim.Adam(
        [{"params": [params["grid_table"]], "scale": 10.0},
         {"params": [p for n, p in params.items() if n != "grid_table"], "scale": 1.0}],
        lr=cfg["lr"], betas=(0.9, 0.99), eps=1e-15)


def _update(opt, loss, cfg, count: int):
    opt.zero_grad(set_to_none=True)
    loss.backward()
    base = cfg["lr"] * 0.1 ** min(count / cfg["iters"], 1.0)
    for group in opt.param_groups:
        group["lr"] = group["scale"] * base
        for p in group["params"]:
            if p.grad is not None:
                p.grad.masked_fill_(torch.isnan(p.grad), 0.0)
    opt.step()


def _settings(cfg, detach_bg=False):
    return nerf.Settings(bound=cfg["bound"], min_near=cfg["min_near"],
                         num_steps=cfg["num_steps"], upsample_steps=cfg["upsample_steps"],
                         soft_mask=cfg["soft_mask"], detach_bg=detach_bg)


def _norms(opt, params):
    """Each parameter's first gradient as Adam took it: its first moment
    after one update over 1 − β1."""
    return {n: float(opt.state[p]["exp_avg"].norm()) / 0.1 for n, p in params.items()}


def _change(params, w0):
    return {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}


def _start(cfg, traffic, seed, device, prec):
    """The field, its Adam, the views and their order, the generator seeded
    as the trainer's, and on the fast path the occupancy grid after the
    set-up's refreshes and the first epoch's (before its first step)."""
    w0 = initial_field(cfg, seed, device)
    params = {n: w.clone().requires_grad_(True) for n, w in w0.items()}
    field = nerf.Field(params, encoder_spec(cfg), cfg["bound"], prec)
    gen = torch.Generator(device=device).manual_seed(inputs.program_seed(seed))
    occ = None
    if recipe.fast(cfg):
        occ = nerf.init_occupancy(recipe.cascade(cfg), cfg["occ_grid_size"], device)
        for _ in range(traffic["occupancy_warmup"] + 1):
            nerf.refresh(occ, field.density, cfg["bound"], cfg["density_thresh"], gen)
    return dict(w0=w0, params=params, field=field, opt=_adam(params, cfg), gen=gen, occ=occ,
                views=inputs.views(seed, traffic["views"], traffic["H"], traffic["W"], device),
                order=inputs.view_order(seed, traffic["views"], traffic["checked_steps"]))


def train_render(cfg, field, rays_o, rays_d, occ, gen, bg=None, detach_bg=False):
    """A training render on the configuration's path."""
    s = _settings(cfg, detach_bg=detach_bg)
    if recipe.fast(cfg):
        return nerf.render_fast(field, rays_o, rays_d, occ, s, recipe.train_candidates(cfg),
                                recipe.n_keep(cfg), cfg["compact_frac"],
                                cfg["compact_block"], gen, bg_color=bg)
    return nerf.render_dense(field, rays_o, rays_d, s, gen, bg_color=bg)


def _render_image(cfg, frozen, rays_o, rays_d, occ, gen, bg):
    """The frozen field's full-frame render on the configuration's path, in
    chunks of ``max_ray_batch`` rays (the tail edge-padded to a whole
    chunk), the fast path marching at the evaluation budget."""
    s = _settings(cfg, detach_bg=cfg["detach_bg"])
    chunk, N = cfg["max_ray_batch"], rays_o.shape[0]
    pad = (-N) % chunk
    if pad:
        rays_o = torch.cat([rays_o, rays_o[-1:].expand(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d[-1:].expand(pad, 3)])
    parts = []
    with torch.no_grad():
        for i in range(0, N + pad, chunk):
            ro, rd = rays_o[i:i + chunk], rays_d[i:i + chunk]
            if recipe.fast(cfg):
                r = nerf.render_fast(frozen, ro, rd, occ, s, recipe.eval_candidates(cfg),
                                     recipe.n_keep(cfg), cfg["compact_frac"],
                                     cfg["compact_block"], gen, bg_color=bg)
            else:
                r = nerf.render_dense(frozen, ro, rd, s, gen, train=False, bg_color=bg)
            parts.append(r["bg"]["image"])
    return torch.cat(parts)[:N]


def _record(out, i, st):
    """After the first step: its gradient as Adam took it (the norms, and
    on the host the gradient itself) and the change."""
    if i == 0:
        out["grads"] = _norms(st["opt"], st["params"])
        out["grad_vecs"] = {n: (st["opt"].state[p]["exp_avg"] / 0.1).float().cpu()
                            for n, p in st["params"].items()}
        out["change1"] = _change(st["params"], st["w0"])


def recon_readings(cfg, traffic, seed: int, device, prec: nerf.Precision = nerf.Precision(),
                   sd: str = "float32", follow=None) -> dict:
    """The reference's first ``checked_steps`` reconstruction steps: each
    step's loss, each parameter's first gradient (its norm and, on the
    host, itself) and the norm of its change after the first and after the
    last step.  ``prec`` lowers the field's precision; ``sd`` and
    ``follow`` have nothing to act on here."""
    with no_tf32():
        st = _start(cfg, traffic, seed, device, prec)
        v = st["views"]
        out = {"losses": []}
        for i in range(traffic["checked_steps"]):
            j = st["order"][i]
            res = train_render(cfg, st["field"], v["rays_o"][j], v["rays_d"][j], st["occ"],
                               st["gen"])
            loss_c = cfg["train_rgb"] * torch.mean((res["image"] - v["rgbs"][j]) ** 2)
            loss_m = cfg["train_conf"] * torch.mean((res["render_mask"][..., 0]
                                                     - v["masks"][j]) ** 2)
            _update(st["opt"], loss_c + loss_m, cfg, i)
            out["losses"].append(float(loss_c.detach()) + float(loss_m.detach()))
            _record(out, i, st)
        out["change"] = _change(st["params"], st["w0"])
        return out


def edit_readings(cfg, traffic, seed: int, device, prec: nerf.Precision = nerf.Precision(),
                  sd: str = "float32", follow=None) -> dict:
    """:func:`recon_readings` of an editing cell, each step's LGIE branch
    (``branches``, True for the local one) and the first step's SDS
    cotangent (``cot``).  ``sd`` ("float32", "bfloat16" or "fp8": bf16
    with fp8 operands) lowers the UNet's and the VAE's precision.
    ``follow``: another side's readings holding its first cotangent; the
    first step's backward is then also taken in two parts, on the host:
    each parameter's gradient of Σ latents·(that cotangent) (``sds_vecs``)
    and of the keep_bg term (``bg_vecs``), the rest of the step as the
    reference computes it."""
    with no_tf32():
        st = _start(cfg, traffic, seed, device, prec)
        params, gen, occ, v = st["params"], st["gen"], st["occ"], st["views"]
        frozen = nerf.Field({n: w.clone() for n, w in st["w0"].items()}, encoder_spec(cfg),
                            cfg["bound"], prec)
        unet, vae = build_sd(cfg, seed, device, "float32" if sd == "float32" else "bfloat16",
                             sd == "fp8")
        emb = inputs.embeddings(seed, device, cfg["unet"]["cross_attention_dim"])
        alphas = _alphas(device)
        H, W = traffic["H"], traffic["W"]
        gate = np.random.RandomState(inputs.program_seed(seed))
        min_step, max_step = int(1000 * 0.02), int(1000 * cfg["max_ratio"])
        pt = {}
        out = {"losses": [], "branches": []}
        for i in range(traffic["checked_steps"]):
            j = st["order"][i]
            ro, rd = v["rays_o"][j], v["rays_d"][j]
            bg = torch.rand(3, generator=gen, device=device)
            if j not in pt:
                pt[j] = _render_image(cfg, frozen, ro, rd, occ, gen, bg)
            use_fg = gate.random() >= cfg["global_ratio"]
            out["branches"].append(bool(use_fg))
            text = emb["text_z_fg"] if use_fg else emb["text_z"]
            t = torch.randint(min_step, max_step + 1, (1,), generator=gen, device=device)
            if use_fg:
                t = (t.to(torch.float64) * cfg["local_t_ratio"]).to(torch.int64)
            res = train_render(cfg, st["field"], ro, rd, occ, gen, bg, cfg["detach_bg"])
            img = res["fg"]["image"] if use_fg else res["image"]
            img = img.reshape(1, H, W, 3).permute(0, 3, 1, 2)
            side = cfg["vae"]["sample_size"]
            img = F.interpolate(img, size=(side, side), mode="bilinear",
                                align_corners=False, antialias=True)
            mean, logvar = vae.moments(2.0 * img - 1.0)
            noise_v = torch.randn(mean.shape, generator=gen, device=device, dtype=mean.dtype)
            latents = (mean + torch.exp(0.5 * logvar) * noise_v) * cfg["vae"]["scaling_factor"]
            noise = torch.randn(latents.shape, generator=gen, device=device)
            with torch.no_grad():
                a = alphas[t].reshape(1, 1, 1, 1)
                noisy = torch.sqrt(a) * latents.detach() + torch.sqrt(1.0 - a) * noise
                eps_u, eps_t = unet(torch.cat([noisy, noisy]), torch.cat([t, t]),
                                    torch.cat([text[0:1], text[1:2]])).float().chunk(2)
                eps_hat = eps_t + cfg["cfg"] * (eps_t - eps_u)
                grad = torch.nan_to_num((1.0 - a) * (eps_hat - noise) * cfg["lambda_sd"])
                loss_sds = 0.5 * (grad ** 2).sum()
            loss_bg = cfg["keep_bg"] * (pt[j].reshape(H, W, 3)
                                        - res["bg"]["image"].reshape(H, W, 3)).abs().mean()
            if i == 0:
                out["cot"] = grad.float().cpu()
                if follow is not None:
                    out["sds_vecs"], out["bg_vecs"] = _follow(params, latents, loss_bg,
                                                              follow["cot"])
            _update(st["opt"], (latents * grad).sum() + loss_bg, cfg, i)
            out["losses"].append(float(loss_sds) + float(loss_bg.detach()))
            _record(out, i, st)
        out["change"] = _change(params, st["w0"])
        return out


def _follow(params: dict, latents, loss_bg, cot) -> tuple:
    """Each parameter's gradient of Σ latents·``cot`` (the SDS part) and of
    loss_bg, NaN-zeroed, on the host; the step's graph is kept for its own
    backward."""
    names = list(params)
    cot = cot.to(device=latents.device, dtype=torch.float32)
    parts = []
    for loss in ((latents * cot).sum(), loss_bg):
        grads = torch.autograd.grad(loss, [params[n] for n in names], retain_graph=True,
                                    allow_unused=True)
        parts.append({n: (torch.zeros_like(params[n]) if g is None
                          else g.masked_fill(torch.isnan(g), 0.0)).float().cpu()
                      for n, g in zip(names, grads)})
    return tuple(parts)


def sd_configs(cfg, dtype="float32"):
    """The reference's UNet and VAE configs for the configuration's."""
    u = cfg["unet"]
    ucfg = sd.UNetConfig(in_channels=u["in_channels"], out_channels=u["out_channels"],
                         block_out_channels=tuple(u["block_out_channels"]),
                         layers_per_block=u["layers_per_block"],
                         cross_attention_dim=u["cross_attention_dim"],
                         attention_head_dim=u["attention_head_dim"],
                         norm_num_groups=u["norm_num_groups"], dtype=dtype)
    vc = cfg["vae"]
    vcfg = sd.VAEConfig(in_channels=vc["in_channels"], latent_channels=vc["latent_channels"],
                        block_out_channels=tuple(vc["block_out_channels"]),
                        layers_per_block=vc["layers_per_block"],
                        norm_num_groups=vc["norm_num_groups"],
                        scaling_factor=vc["scaling_factor"], dtype=dtype)
    return ucfg, vcfg


def build_sd(cfg, seed, device, dtype="float32", fp8=False):
    """The UNet and the VAE with the seed's weights, in ``dtype``, their
    operands rounded to fp8 with ``fp8``."""
    ucfg, vcfg = sd_configs(cfg, dtype)
    unet = sd.build(sd.UNet2DCondition, ucfg, device=device).requires_grad_(False)
    inputs.fill_sd(unet, seed, 5, device)
    vae = sd.build(sd.AutoencoderKL, vcfg, device=device).requires_grad_(False)
    inputs.fill_sd(vae, seed, 6, device)
    if dtype != "float32":
        unet.to(ucfg.compute_dtype)
        vae.to(vcfg.compute_dtype)
    if fp8:
        sd.set_fp8(unet)
        sd.set_fp8(vae)
    return unet, vae


def _alphas(device):
    """Stable Diffusion's scaled-linear DDPM ᾱ_t over 1000 steps."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas).astype(np.float32), device=device)
