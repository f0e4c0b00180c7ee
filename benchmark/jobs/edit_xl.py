"""Editing with SDXL base 1.0 as the guidance: ``jobs/edit.py``'s LGIE/SDS
steps on the port's ``Trainer`` (``--sd_version xl``), K steps a dispatch
through ``engine/editing.py::editing_steps_many``, with the UNet of
``reference/sdxl.py`` in the plain reference.

SDXL's UNet also takes each prompt's pooled embedding.  The harness draws
the prompts' contexts (``lib/inputs.py::embeddings``) and hands them to
the trainer as ``text_z*``; this job draws the pooled embeddings the same
way (:func:`pooled_embeddings`, from the trainer's seed) and hands them
over in :func:`stash`, which is entered before the first checked step, the
one that captures the graph.  The reference takes the same draws.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.jobs import edit
from benchmark.lib import counts, inputs
from benchmark.reference import sd, sdxl
from benchmark.reference import train as ref

try:
    from customnerf_torch.guidance.text import PooledText
except ImportError as e:        # a program without SDXL guidance: fail at once
    raise SystemExit(f"[benchmark] edit_xl needs the program's SDXL guidance: {e}") from e

GUIDANCE = True
POOLED_PURPOSE = 7          # the generator purpose of the pooled draw (lib/inputs.py)
NAMES = ("text_z", "text_z_fg", "text_z_norm", "text_z_norm_fg", "text_z_bg")

finish_setup = edit.finish_setup


def pooled_width(unet: dict) -> int:
    """The pooled text embedding's width: add_embedding's input less the six
    time ids' embeddings."""
    return unet["projection_class_embeddings_input_dim"] - 6 * unet["addition_time_embed_dim"]


def pooled_embeddings(program_seed: int, device, width: int) -> dict:
    """Each prompt's pooled [uncond; cond] embedding, [2, width], drawn as
    ``inputs.embeddings`` draws the contexts: one shared negative prompt."""
    g = inputs.generator(program_seed, POOLED_PURPOSE, device)
    z = torch.randn(len(NAMES) + 1, width, generator=g, device=device)
    return {n: torch.stack([z[0], z[i + 1]]) for i, n in enumerate(NAMES)}


def time_ids(cfg: dict) -> list:
    """The base pipeline's time ids for the VAE's side S: (S, S, 0, 0, S, S),
    original size, crop corner and target size (the program's rule)."""
    side = cfg["vae"]["sample_size"]
    return [side, side, 0, 0, side, side]


@contextlib.contextmanager
def stash(trainer):
    """The pooled embeddings handed to the trainer (each ``text_z*`` becomes
    its ``PooledText``), then ``jobs/edit.py``'s hold of the first step's
    SDS cotangent."""
    u = trainer.guidance.unet.cfg
    pooled = pooled_embeddings(int(trainer.opt.seed), trainer.device, u.text_embeds_dim)
    for name in NAMES:
        held = getattr(trainer, name)
        if not isinstance(held, PooledText):
            setattr(trainer, name, PooledText(held, pooled[name]))
    with edit.stash(trainer) as held:
        yield held


def build_sd(cfg, seed, device, dtype="float32", fp8=False):
    """The SDXL UNet and the VAE with the seed's weights (``train.build_sd``
    with the SDXL UNet)."""
    ucfg = sdxl.unet_config(cfg["unet"], dtype)
    _, vcfg = ref.sd_configs(cfg, dtype)
    unet = sd.build(sdxl.UNet, ucfg, device=device).requires_grad_(False)
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


def readings(cfg, traffic, seed: int, device, prec=None, sd: str = "float32",
             follow=None) -> dict:
    """``train.edit_readings`` with the SDXL UNet (its pooled embedding and
    time ids for both CFG halves) and the VAE at the configuration's side:
    each step's loss and LGIE branch, the first step's gradient, cotangent
    and (with ``follow``) the two parts of its backward, each parameter's
    change.  ``sd`` ("float32", "bfloat16" or "fp8") lowers the UNet's and
    the VAE's precision."""
    from benchmark.reference import nerf
    prec = prec or nerf.Precision()
    with ref.no_tf32():
        st = ref._start(cfg, traffic, seed, device, prec)
        params, gen, occ, v = st["params"], st["gen"], st["occ"], st["views"]
        frozen = nerf.Field({n: w.clone() for n, w in st["w0"].items()},
                            ref.encoder_spec(cfg), cfg["bound"], prec)
        unet, vae = build_sd(cfg, seed, device, "float32" if sd == "float32" else "bfloat16",
                             sd == "fp8")
        emb = inputs.embeddings(seed, device, cfg["unet"]["cross_attention_dim"])
        pooled = pooled_embeddings(inputs.program_seed(seed), device, pooled_width(cfg["unet"]))
        ids = torch.tensor(time_ids(cfg), dtype=torch.float32, device=device).expand(2, 6)
        alphas = ref._alphas(device)
        H, W, side = traffic["H"], traffic["W"], cfg["vae"]["sample_size"]
        gate = np.random.RandomState(inputs.program_seed(seed))
        min_step, max_step = int(1000 * 0.02), int(1000 * cfg["max_ratio"])
        pt = {}
        out = {"losses": [], "branches": []}
        for i in range(traffic["checked_steps"]):
            j = st["order"][i]
            ro, rd = v["rays_o"][j], v["rays_d"][j]
            bg = torch.rand(3, generator=gen, device=device)
            if j not in pt:
                pt[j] = ref._render_image(cfg, frozen, ro, rd, occ, gen, bg)
            use_fg = gate.random() >= cfg["global_ratio"]
            out["branches"].append(bool(use_fg))
            name = "text_z_fg" if use_fg else "text_z"
            text, pool = emb[name], pooled[name]
            t = torch.randint(min_step, max_step + 1, (1,), generator=gen, device=device)
            if use_fg:
                t = (t.to(torch.float64) * cfg["local_t_ratio"]).to(torch.int64)
            res = ref.train_render(cfg, st["field"], ro, rd, occ, gen, bg, cfg["detach_bg"])
            img = res["fg"]["image"] if use_fg else res["image"]
            img = F.interpolate(img.reshape(1, H, W, 3).permute(0, 3, 1, 2), size=(side, side),
                                mode="bilinear", align_corners=False, antialias=True)
            mean, logvar = vae.moments(2.0 * img - 1.0)
            noise_v = torch.randn(mean.shape, generator=gen, device=device, dtype=mean.dtype)
            latents = (mean + torch.exp(0.5 * logvar) * noise_v) * cfg["vae"]["scaling_factor"]
            noise = torch.randn(latents.shape, generator=gen, device=device)
            with torch.no_grad():
                a = alphas[t].reshape(1, 1, 1, 1)
                noisy = torch.sqrt(a) * latents.detach() + torch.sqrt(1.0 - a) * noise
                eps_u, eps_t = unet(torch.cat([noisy, noisy]), torch.cat([t, t]), text,
                                    pool, ids).float().chunk(2)
                eps_hat = eps_t + cfg["cfg"] * (eps_t - eps_u)
                grad = torch.nan_to_num((1.0 - a) * (eps_hat - noise) * cfg["lambda_sd"])
                loss_sds = 0.5 * (grad ** 2).sum()
            loss_bg = cfg["keep_bg"] * (pt[j].reshape(H, W, 3)
                                        - res["bg"]["image"].reshape(H, W, 3)).abs().mean()
            if i == 0:
                out["cot"] = grad.float().cpu()
                if follow is not None:
                    out["sds_vecs"], out["bg_vecs"] = ref._follow(params, latents, loss_bg,
                                                                  follow["cot"])
            ref._update(st["opt"], (latents * grad).sum() + loss_bg, cfg, i)
            out["losses"].append(float(loss_sds) + float(loss_bg.detach()))
            ref._record(out, i, st)
        out["change"] = ref._change(params, st["w0"])
        return out


def sdxl_counts(cfg: dict, weight_bytes: int = 2) -> dict:
    """(flops, bytes) of the SDXL UNet's forward at the CFG batch on the
    VAE's latents, and of the VAE encoder's forward and of its backward to
    the image at the configuration's side, counted on the meta device with
    the reference's modules (``counts.sd_counts``' rules)."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = torch.device("meta")
    ucfg = sdxl.unet_config(cfg["unet"])
    _, vcfg = ref.sd_configs(cfg)
    side = cfg["vae"]["sample_size"]
    unet = sd.build(sdxl.UNet, ucfg, device=meta).requires_grad_(False)
    vae = sd.build(sd.AutoencoderKL, vcfg, device=meta).requires_grad_(False)
    lat = torch.empty(2, 4, side // 8, side // 8, device=meta)
    ctx = torch.empty(2, 77, ucfg.cross_attention_dim, device=meta)
    pooled = torch.empty(2, pooled_width(cfg["unet"]), device=meta)
    ids = torch.empty(2, 6, device=meta)
    with FlopCounterMode(display=False) as fc:
        unet(lat, torch.zeros(2, dtype=torch.long, device=meta), ctx, pooled, ids)
    unet_flops = fc.get_total_flops()
    img = torch.empty(1, 3, side, side, device=meta, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        mean, logvar = vae.moments(img)
        z = mean + logvar
    enc_flops = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        z.sum().backward()
    bwd_flops = fc.get_total_flops()
    n_unet = sum(p.numel() for p in unet.parameters())
    n_enc = sum(p.numel() for m in (vae.encoder, vae.quant_conv) for p in m.parameters())
    enc_bytes = weight_bytes * n_enc + 4 * (img.numel() + 2 * mean.numel())
    io = 2 * 2 * lat.numel() + ctx.numel() + pooled.numel() + ids.numel()
    return {"unet": (unet_flops, weight_bytes * n_unet + 4 * io),
            "vae_forward": (enc_flops, enc_bytes),
            "vae_backward": (bwd_flops, 2 * enc_bytes)}


def guidance_work(cfg) -> tuple:
    """The UNet's launches a step as (flops, bytes, peak), and the model
    FLOPs of the guidance: the UNet's forward at the CFG batch and the VAE
    encoder's forward and backward at the configuration's side."""
    c = sdxl_counts(cfg)
    model = c["unet"][0] + c["vae_forward"][0] + c["vae_backward"][0]
    return {"unet": [(*c["unet"], counts.PEAK_BF16_FLOPS)]}, model
