"""Score Distillation Sampling guidance with Stable Diffusion 1.5
(counterpart of ``customnerf_tpu/guidance/sds.py``).

Semantics kept from the reference (``nerf/sd.py:34-154``):
  * t ∈ [0.02·T, max_ratio·T], an inclusive randint; ``--stage_time``
    halves max_step once ``global_step > iters/2``; then ``int(t·t_ratio)``.
  * **text-anchored CFG**: ε̂ = ε_text + cfg·(ε_text − ε_uncond), the UNet
    run without a graph on ``[noisy; noisy]`` against ``[uncond; cond]``.
  * grad = (1−ᾱ_t)·(ε̂ − ε)·λ_sd with NaNs zeroed; the loss value is
    0.5·Σ grad².

The stack is built at full SD 1.5 width (UNet, VAE, CLIP ViT-L/14 text).
Precision is the JAX package's rule (``sds.py:60-66,120-128``): on the card
the UNet and VAE are stored in bf16, once their weights and the adapters
have loaded, and compute in bf16 under flax's policy (``layers.py``); on the
CPU they stay f32.  The text tower stays f32 either way.  ε comes out f32,
and the SDS gradient is formed in f32 from it.  Weights are random, drawn
in f32 on the trainer's device from a ``torch.Generator`` seeded with
``--seed`` (the same draw in either precision), unless ``--sd_weights``
names a local diffusers directory.  ``--use_cd <dir>``
(outside ``--test``) loads a Custom Diffusion artifact pair after the
weights: the adapters go into every UNet call as ``cd_kv`` and the modifier
tokens are registered on the text encoder, so prompts carry ``<new1>``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from customnerf_torch.device import resolve_device
from customnerf_torch.guidance.layers import build, n_params
from customnerf_torch.guidance.scheduler import DDPMSchedule
from customnerf_torch.guidance.text import TextEncoder
from customnerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from customnerf_torch.guidance.vae import AutoencoderKL, VAEConfig

# parameter counts of the SD 1.5 stack at full width: UNet, VAE, CLIP
# ViT-L/14 text encoder, and the CLIP ViT-B/32 of --clip_view (equal to the
# JAX package's, tests/test_torch_guidance.py)
FULL_WIDTH_PARAMS = {"unet": 859_520_964, "vae": 83_653_863,
                     "text_encoder": 123_060_480, "clip_view": 151_277_313}

RANDOM_WEIGHTS_ERROR = (
    "editing requested without --sd_weights: Stable Diffusion would run with "
    "RANDOM weights and the edit would be noise. Point --sd_weights at a "
    "local SD checkpoint directory, or pass --allow_random_guidance to opt "
    "into random weights (plumbing tests/benchmarks only).")


def sd_dtype(device) -> str:
    """The JAX package's rule: bf16 on an accelerator, f32 on the CPU."""
    return "float32" if torch.device(device).type == "cpu" else "bfloat16"


def check_supported(opt):
    if str(opt.sd_version).startswith("2"):
        raise NotImplementedError(
            f"--sd_version {opt.sd_version} is not ported yet (ROADMAP.md "
            f"queue A, item 'SD 2.x')")


class StableDiffusionGuidance:
    """``dtype`` ("float32" | "bfloat16") is the JAX signature's compute
    dtype; ``None`` takes :func:`sd_dtype`'s rule.  Where the JAX package
    forces f32 on a CPU whatever it is given, an explicit ``dtype`` stands
    here, so that the bf16 stack can be held against the JAX modules on a
    CPU."""

    def __init__(self, opt, device=None, unet_cfg: UNetConfig = UNetConfig(),
                 vae_cfg: VAEConfig = VAEConfig(), text_encoder=None,
                 dtype: str | None = None):
        check_supported(opt)
        if not opt.sd_weights and (opt.pretrained and not opt.test
                                   and not opt.allow_random_guidance):
            # a 10k-iter semantic run must not silently distill noise
            raise RuntimeError(RANDOM_WEIGHTS_ERROR)
        self.opt = opt
        self.device = resolve_device(device)
        self.dtype = dtype or sd_dtype(self.device)
        unet_cfg = dataclasses.replace(unet_cfg, dtype=self.dtype)
        vae_cfg = dataclasses.replace(vae_cfg, dtype=self.dtype)
        t0 = time.time()
        gen = torch.Generator(device=self.device).manual_seed(int(opt.seed))
        self.unet = build(UNet2DCondition, unet_cfg, device=self.device,
                          generator=gen).eval().requires_grad_(False)
        self.vae = build(AutoencoderKL, vae_cfg, device=self.device,
                         generator=gen).eval().requires_grad_(False)
        self.text_encoder = text_encoder or TextEncoder(
            opt.sd_version, weights_dir=opt.sd_weights, device=self.device,
            generator=gen)
        self.text_encoder.model.eval().requires_grad_(False)
        if opt.sd_weights:
            from customnerf_torch.guidance.weights import load_sd_weights
            load_sd_weights(self, opt.sd_weights)
        else:
            print("[WARN] no --sd_weights given: SD runs with random weights "
                  "(framework-functional; provide a local checkpoint for "
                  "real edits).")
        # after the weights: a grown token table would not load, and the
        # tokens' rows must survive the load
        self.cd_kv = None
        if opt.use_cd is not None and not opt.test:
            self.load_cd(opt.use_cd)
        # the storage cast, after the weights and the adapters have loaded
        self.unet.to(self.unet.cfg.compute_dtype)
        self.vae.to(self.vae.cfg.compute_dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.time() - t0

        self.scheduler = DDPMSchedule(device=self.device)
        self.num_train_timesteps = self.scheduler.num_train_timesteps
        self.min_step = int(self.num_train_timesteps * 0.02)
        self.max_step = int(self.num_train_timesteps * opt.max_ratio)
        self.alphas = self.scheduler.alphas_cumprod

    def load_cd(self, model_dir: str) -> dict:
        """``--use_cd``: the artifact pair in ``model_dir`` → ``self.cd_kv``
        (None without adapter weights) and its tokens registered on the text
        encoder; returns {token: embedding}."""
        from customnerf_torch.guidance.custom_diffusion import load_cd_artifacts
        self.cd_kv, token_embeds = load_cd_artifacts(model_dir, self.text_encoder,
                                                     device=self.device)
        if token_embeds:
            print(f"[INFO] loaded Custom Diffusion adapters + "
                  f"{list(token_embeds)} from {model_dir}")
        return token_embeds

    def param_counts(self) -> dict:
        return {"unet": n_params(self.unet), "vae": n_params(self.vae),
                "text_encoder": n_params(self.text_encoder.model)}

    # ---------------------------------------------------------------- text
    def get_text_embeds(self, prompt, negative_prompt):
        return self.text_encoder.get_text_embeds(prompt, negative_prompt)

    # --------------------------------------------------------------- image
    def encode_imgs(self, images, generator=None, noise=None):
        """images [B, 3, H, W] in [0, 1] → latents [B, 4, H/8, W/8], with
        the graph to the images."""
        return self.vae.encode(2.0 * images - 1.0, generator=generator,
                               noise=noise)

    # ----------------------------------------------------------------- SDS
    @torch.no_grad()
    def sds_grad(self, latents, text_embeddings, t, noise):
        """dL_sds/dlatents and the loss value 0.5·Σ grad², for latents
        [1, 4, h, w], text_embeddings [uncond; cond] and noise ε, all f32, at
        timestep ``t`` (a [1] int64 tensor on the latents' device, or an
        int); the UNet casts its inputs, and the gradient is formed in f32
        from its f32 ε (the JAX ``sds_loss_fn``).  Nothing here reads t on
        the host."""
        t = torch.as_tensor(t, device=latents.device).reshape(1)
        noisy = self.scheduler.add_noise(latents, noise, t)
        latent_in = torch.cat([noisy, noisy])
        eps_uncond, eps_text = self.unet(latent_in, t.expand(latent_in.shape[0]),
                                         text_embeddings, cd_kv=self.cd_kv).chunk(2)
        eps_hat = eps_text + self.opt.cfg * (eps_text - eps_uncond)
        w = 1.0 - self.alphas.index_select(0, t)
        grad = torch.nan_to_num(w * (eps_hat.float() - noise) * self.opt.lambda_sd)
        return grad, 0.5 * (grad ** 2).sum()

    def sample_timestep(self, generator, global_step=None, t_ratio: float = 1.0):
        """Reference t sampling incl. ``--stage_time`` (sd.py:120-132), on
        the generator's device: a [1] int64 tensor, ``int(t · t_ratio)``
        computed there (no host sync)."""
        min_step, max_step = self.min_step, self.max_step
        if self.opt.stage_time and global_step is not None:
            if global_step > self.opt.iters / 2:
                max_step = int(max_step * 0.5)
        t = torch.randint(min_step, max_step + 1, (1,), generator=generator,
                          device=generator.device)
        if t_ratio == 1.0:
            return t
        return (t.to(torch.float64) * t_ratio).to(torch.int64)
