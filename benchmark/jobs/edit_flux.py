"""Editing with FLUX.1-dev as the guidance: ``jobs/edit.py``'s LGIE/SDS
steps on the port's ``Trainer`` (``--sd_version flux-dev``), K steps a
dispatch through ``engine/editing.py::editing_steps_many``, with the
transformer of ``reference/flux.py`` in the plain reference.

The harness builds no guidance for this job (``GUIDANCE`` is False): its
build draws every weight of a model in one f32 call, 47.6 GB for FLUX's
transformer.  :func:`stash`, entered before the first checked step (the
one that captures the graph), builds the port's guidance instead
(:func:`build_guidance`), writes the seed's weights into it one tensor at a
time (``reference/flux.py::draw`` for the transformer, ``inputs.fill_sd``
for the VAE) and hands the trainer each prompt's drawn embedding, T5's
context [1, 512, 4096] and CLIP-L's pooled state [1, 768], as a
``PooledText``.  The reference takes the same draws and builds its f32
transformer one block at a time.

The port's guidance keeps its denoiser under ``unet``, so the harness's
timed span of one step's denoiser call (``lib/training.py::spans``) is the
transformer's here: ``metrics/dit_ms.edit_flux.py`` reads it, and
:func:`guidance_work` gives its work under the same name.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.jobs import edit
from benchmark.lib import counts, inputs
from benchmark.reference import flux as rf
from benchmark.reference import sd as ref_sd
from benchmark.reference import train as ref

try:
    from customnerf_torch.guidance.flux import FluxTransformer  # noqa: F401
    from customnerf_torch.guidance.text import PooledText
except ImportError as e:        # a program without FLUX guidance: fail at once
    raise SystemExit(f"[benchmark] edit_flux needs the program's FLUX guidance: {e}") from e

GUIDANCE = False
# the generator purposes of the draws (lib/inputs.py's numbering)
CONTEXT, TRANSFORMER, VAE, POOLED = 4, 5, 6, 7
NAMES = ("text_z", "text_z_fg", "text_z_norm", "text_z_norm_fg", "text_z_bg")

finish_setup = edit.finish_setup


def build_guidance(trainer):
    """The port's guidance for the trainer's flags (``--sd_version
    flux-dev``: published widths), on its device."""
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    return StableDiffusionGuidance(trainer.opt, device=trainer.device)


def prompt_embeddings(program_seed: int, device, tokens: int, width: int,
                      pooled_width: int) -> dict:
    """Each prompt's context [1, tokens, width] and pooled embedding
    [1, pooled_width], drawn from the seed (no negative prompt)."""
    z = torch.randn(len(NAMES), 1, tokens, width,
                    generator=inputs.generator(program_seed, CONTEXT, device), device=device)
    p = torch.randn(len(NAMES), 1, pooled_width,
                    generator=inputs.generator(program_seed, POOLED, device), device=device)
    return {n: (z[i], p[i]) for i, n in enumerate(NAMES)}


@contextlib.contextmanager
def stash(trainer):
    """The guidance built and given the seed's weights and each prompt's
    embedding (module docstring), then ``jobs/edit.py``'s hold of the first
    step's SDS cotangent."""
    if trainer.guidance is None:
        g = build_guidance(trainer)
        seed, dev = int(trainer.opt.seed), trainer.device
        rf.fill(g.unet, seed, TRANSFORMER, dev)
        inputs.fill_sd(g.vae, seed, VAE, dev)
        trainer.guidance = g
        u = g.unet.cfg
        tokens = g.text_encoder.model.text_encoder_2.cfg.max_length
        for name, (ctx, pooled) in prompt_embeddings(
                seed, dev, tokens, u.joint_attention_dim, u.pooled_projection_dim).items():
            setattr(trainer, name, PooledText(ctx, pooled))
    with edit.stash(trainer) as held:
        yield held


def build_vae(cfg, seed: int, device, sd: str = "float32"):
    """The reference's VAE with the seed's weights, in f32, bf16, or bf16
    with fp8 operands."""
    v = cfg["vae"]
    vcfg = rf.vae_config(v, "float32" if sd == "float32" else "bfloat16")
    vae = ref_sd.build(rf.VAE, vcfg, v["shift_factor"], device=device).requires_grad_(False)
    inputs.fill_sd(vae, seed, VAE, device)
    if sd != "float32":
        vae.to(vcfg.compute_dtype)
    if sd == "fp8":
        ref_sd.set_fp8(vae)
    return vae


def readings(cfg, traffic, seed: int, device, prec=None, sd: str = "float32",
             follow=None) -> dict:
    """``train.edit_readings`` with FLUX.1-dev: one transformer call a step
    at batch 1 with the guidance g, the flow SDS gradient, the VAE's
    shifted latents at the configuration's side: each step's loss and LGIE
    branch, the first step's gradient, cotangent and (with ``follow``) the
    two parts of its backward, each parameter's change.  ``sd``
    ("float32", "bfloat16" or "fp8") lowers the transformer's and the VAE's
    precision."""
    from benchmark.reference import nerf
    prec = prec or nerf.Precision()
    u, pipe = cfg["unet"], cfg["unet"]["pipeline"]
    pseed = inputs.program_seed(seed)
    dtype = torch.float32 if sd == "float32" else torch.bfloat16
    with ref.no_tf32():
        st = ref._start(cfg, traffic, seed, device, prec)
        params, gen, occ, v = st["params"], st["gen"], st["occ"], st["views"]
        frozen = nerf.Field({n: w.clone() for n, w in st["w0"].items()},
                            ref.encoder_spec(cfg), cfg["bound"], prec)
        vae = build_vae(cfg, pseed, device, sd)
        model = ref_sd.build(rf.Flux, rf.flux_params(u), device="meta")
        take = rf.streamed(pseed, TRANSFORMER, device, dtype, fp8=sd == "fp8")
        emb = prompt_embeddings(pseed, device, pipe["max_sequence_length"],
                                u["joint_attention_dim"], u["pooled_projection_dim"])
        H, W, side = traffic["H"], traffic["W"], cfg["vae"]["sample_size"]
        gate = np.random.RandomState(pseed)
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
            ctx, pooled = emb["text_z_fg" if use_fg else "text_z"]
            t = torch.randint(min_step, max_step + 1, (1,), generator=gen, device=device)
            if use_fg:
                t = (t.to(torch.float64) * cfg["local_t_ratio"]).to(torch.int64)
            res = ref.train_render(cfg, st["field"], ro, rd, occ, gen, bg, cfg["detach_bg"])
            img = res["fg"]["image"] if use_fg else res["image"]
            img = F.interpolate(img.reshape(1, H, W, 3).permute(0, 3, 1, 2), size=(side, side),
                                mode="bilinear", align_corners=False, antialias=True)
            mean, logvar = vae.moments(2.0 * img - 1.0)
            noise_v = torch.randn(mean.shape, generator=gen, device=device, dtype=mean.dtype)
            latents = vae.latents(mean, logvar, noise_v)
            noise = torch.randn(latents.shape, generator=gen, device=device)
            with torch.no_grad():
                grad, loss_sds = rf.sds_grad(model, latents.detach(), noise, t, ctx, pooled,
                                             pipe["guidance_scale"], cfg["lambda_sd"], take,
                                             dtype)
            take.release()
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


def flux_counts(cfg: dict, weight_bytes: int = 2) -> dict:
    """(flops, bytes) of the transformer's forward at batch 1 on the VAE's
    latents against the prompt's context, and of the VAE encoder's forward
    and of its backward to the image at the configuration's side, counted
    on the meta device with the reference's modules (``counts.sd_counts``'
    rules: weights at ``weight_bytes`` a parameter, inputs and outputs
    f32)."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = torch.device("meta")
    u, v = cfg["unet"], cfg["vae"]
    side = v["sample_size"]
    lat = torch.empty(1, v["latent_channels"], side // 8, side // 8, device=meta)
    ctx = torch.empty(1, u["pipeline"]["max_sequence_length"], u["joint_attention_dim"],
                      device=meta)
    pooled = torch.empty(1, u["pooled_projection_dim"], device=meta)
    model = ref_sd.build(rf.Flux, rf.flux_params(u), device=meta).requires_grad_(False)
    one = torch.ones(1, device=meta)
    with FlopCounterMode(display=False) as fc:
        rf.velocity(model, lat, one, ctx, pooled, one)
    dit_flops = fc.get_total_flops()
    vae = ref_sd.build(rf.VAE, rf.vae_config(v), v["shift_factor"], device=meta)
    vae.requires_grad_(False)
    img = torch.empty(1, 3, side, side, device=meta, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        mean, logvar = vae.moments(img)
        z = mean + logvar
    enc_flops = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        z.sum().backward()
    bwd_flops = fc.get_total_flops()
    n_dit = sum(p.numel() for p in model.parameters())
    n_enc = sum(p.numel() for p in vae.encoder.parameters())
    enc_bytes = weight_bytes * n_enc + 4 * (img.numel() + 2 * mean.numel())
    io = 2 * lat.numel() + ctx.numel() + pooled.numel()
    return {"dit": (dit_flops, weight_bytes * n_dit + 4 * io),
            "vae_forward": (enc_flops, enc_bytes),
            "vae_backward": (bwd_flops, 2 * enc_bytes)}


def guidance_work(cfg) -> tuple:
    """The transformer's launches a step as (flops, bytes, peak), under the
    harness's name of the denoiser's span, and the model FLOPs of the
    guidance: the transformer's forward and the VAE encoder's forward and
    backward at the configuration's side."""
    c = flux_counts(cfg)
    model = c["dit"][0] + c["vae_forward"][0] + c["vae_backward"][0]
    return {"unet": [(*c["dit"], counts.PEAK_BF16_FLOPS)]}, model
