"""Score Distillation Sampling guidance with Stable Diffusion 1.5, 2.0, 2.1,
SDXL base 1.0 or FLUX.1-dev (counterpart of ``customnerf_tpu/guidance/sds.py``,
which has neither SDXL nor FLUX).

Semantics kept from the reference (``nerf/sd.py:34-154``):
  * t ∈ [0.02·T, max_ratio·T], an inclusive randint; ``--stage_time``
    halves max_step once ``global_step > iters/2``; then ``int(t·t_ratio)``.
  * **text-anchored CFG**: ε̂ = ε_text + cfg·(ε_text − ε_uncond), the UNet
    run without a graph on ``[noisy; noisy]`` against ``[uncond; cond]``.
  * grad = (1−ᾱ_t)·(ε̂ − ε)·λ_sd with NaNs zeroed; the loss value is
    0.5·Σ grad².

The stack is built at full width for ``--sd_version``, as the JAX package
builds it (``sds.py:62-71``): SD 1.x's UNet and CLIP ViT-L/14 text tower,
or SD 2.x's UNet (a 1024-wide context, 64-wide heads at every level) and
OpenCLIP ViT-H text tower (:func:`unet_config`, ``text.text_config``); the
VAE is the same for both.  ``--sd_version xl`` builds SDXL base 1.0: its
UNet (``unet.sdxl_unet_config``), the two text towers
(``text.DualTextEncoder``) and the same VAE at 1024² with scaling 0.13025
(:func:`vae_config`).  Its prompts embed as ``text.PooledText`` (the
context and the pooled embedding), and every UNet call adds the
"text_time" conditioning: the pooled embedding of each CFG half and the
time ids (S, S, 0, 0, S, S) for the VAE's side S: original size, crop
corner (0, 0) and target size, the base pipeline's defaults for a 1024²
target.  ``--use_cd`` and multi-scene editing refuse xl.

``--sd_version flux-dev`` builds FLUX.1-dev: its rectified-flow transformer
(``flux.FluxTransformer``, 11.9 B parameters), T5 v1.1 XXL's encoder and
CLIP-L (``text.FluxTextEncoder``: the context and the pooled embedding, no
negative prompt) and its VAE (16 latent channels, no quant convs, latents
(z − 0.1159)·0.3611 at 1024²).  The model is guidance-distilled: one call
at batch S (no CFG batch) with g = :data:`FLUX_GUIDANCE`.  The SDS step on
rectified flow (:meth:`StableDiffusionGuidance.flow_grad_batch`): the
port's integer t gives σ₀ = t/1000, shifted for the image's token count
as FLUX.1-dev's scheduler shifts it (:func:`flow_sigma`: μ = 1.15 at 4,096
tokens), x_σ = (1 − σ)·x₀ + σ·ε, ε̂ = x_σ + (1 − σ)·v̂ and
grad = w(σ)·(ε̂ − ε)·λ_sd with w(σ) = σ² / ((1 − σ)² + σ²), the 1 − ᾱ_t of
the SD step at the same signal-to-noise ratio.  ``--use_cd``, multi-scene
editing and Custom Diffusion tuning refuse flux-dev, and so does
``--sd_weights`` until the loader has FLUX's, T5's and CLIP's files.  The
transformer, the VAE and T5 are stored in bf16 on the card, drawn one
tensor at a time (an f32 copy of the transformer is 47.6 GB); CLIP-L stays
f32.
A caller's ``unet_cfg`` (reduced-width tests) must take the text tower's
width as its context.
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
The build, draw or load and cast is the tracer's counter
``guidance_build`` (``engine/spans.py``), with its seconds.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from customnerf_torch.device import resolve_device
from customnerf_torch.engine import spans
from customnerf_torch.guidance.flux import FluxConfig, FluxTransformer
from customnerf_torch.guidance.layers import build, n_params
from customnerf_torch.guidance.scheduler import DDPMSchedule
from customnerf_torch.guidance.text import make_text_encoder
from customnerf_torch.guidance.unet import (UNet2DCondition, UNetConfig,
                                            sd2_unet_config, sdxl_unet_config)
from customnerf_torch.guidance.vae import AutoencoderKL, VAEConfig

# parameter counts of the full-width stack by SD family (sd_family): UNet,
# VAE, text encoder (CLIP ViT-L/14 for 1.x, OpenCLIP ViT-H for 2.x, both
# towers for xl) and the CLIP ViT-B/32 of --clip_view; 1.x and 2.x equal to
# the JAX package's (tests/test_torch_guidance.py, tests/test_torch_sd2.py),
# xl to the plain reference's (tests/test_torch_sdxl.py)
FULL_WIDTH_PARAMS = {
    "1.x": {"unet": 859_520_964, "vae": 83_653_863, "text_encoder": 123_060_480,
            "clip_view": 151_277_313},
    "2.x": {"unet": 865_910_724, "vae": 83_653_863, "text_encoder": 340_387_840,
            "clip_view": 151_277_313},
    "xl": {"unet": 2_567_463_684, "vae": 83_653_863, "text_encoder": 817_720_320,
           "clip_view": 151_277_313},
    # "unet" is the denoiser, FLUX's transformer; the text encoder CLIP-L
    # and T5 v1.1 XXL's encoder (4,762,310,656): the plain reference's
    # counts (tests/test_torch_flux.py)
    "flux": {"unet": 11_901_408_320, "vae": 83_819_683, "text_encoder": 4_885_371_136,
             "clip_view": 151_277_313},
}

# FLUX.1-dev: the pipeline's default guidance, and the scheduler's shift of
# σ for the image's token count: μ from 0.5 at 256 tokens to 1.15 at 4,096
# (scheduler_config.json: base_shift, max_shift, base/max_image_seq_len)
FLUX_GUIDANCE = 3.5
FLUX_SHIFT = ((256, 0.5), (4096, 1.15))

RANDOM_WEIGHTS_ERROR = (
    "editing requested without --sd_weights: Stable Diffusion would run with "
    "RANDOM weights and the edit would be noise. Point --sd_weights at a "
    "local SD checkpoint directory, or pass --allow_random_guidance to opt "
    "into random weights (plumbing tests/benchmarks only).")


def sd_dtype(device) -> str:
    """The JAX package's rule: bf16 on an accelerator, f32 on the CPU."""
    return "float32" if torch.device(device).type == "cpu" else "bfloat16"


def sd_family(sd_version) -> str:
    """"xl" for SDXL, "flux" for FLUX.1-dev, "2.x" for 2.0 and 2.1, "1.x"
    otherwise: the JAX package's test (``sd_version.startswith("2")``)
    besides xl and flux-dev."""
    version = str(sd_version).lower()
    if version == "xl":
        return "xl"
    if version == "flux-dev":
        return "flux"
    return "2.x" if version.startswith("2") else "1.x"


def unet_config(sd_version):
    """The denoiser for ``sd_version`` (the JAX package's UNet for 1.x and
    2.x, ``sds.py:62-71``; FLUX.1-dev's transformer), in f32 until the
    guidance sets its compute dtype."""
    return {"2.x": sd2_unet_config, "xl": sdxl_unet_config, "flux": FluxConfig}.get(
        sd_family(sd_version), UNetConfig)()


def vae_config(sd_version) -> VAEConfig:
    """SD's AutoencoderKL: at 512² with scaling 0.18215, for xl at 1024²
    with scaling 0.13025, for flux-dev at 1024² with 16 latent channels, no
    quant convs and latents (z − 0.1159)·0.3611 (``vae/config.json``)."""
    family = sd_family(sd_version)
    if family == "xl":
        return VAEConfig(sample_size=1024, scaling_factor=0.13025)
    if family == "flux":
        return VAEConfig(latent_channels=16, sample_size=1024, scaling_factor=0.3611,
                         shift_factor=0.1159, use_quant_conv=False,
                         use_post_quant_conv=False)
    return VAEConfig()


def flow_sigma(t, tokens: int):
    """FLUX.1-dev's σ for the port's integer timestep t (any shape, on its
    device): σ₀ = t/1000 shifted by μ, linear in the image's ``tokens``
    between :data:`FLUX_SHIFT`'s points (1.15 at 4,096):
    σ = e^μ / (e^μ + 1/σ₀ − 1), f32."""
    (n0, mu0), (n1, mu1) = FLUX_SHIFT
    em = math.exp(mu0 + (mu1 - mu0) * (tokens - n0) / (n1 - n0))
    s0 = t.float() / 1000.0
    return em / (em + 1.0 / s0 - 1.0)


def time_ids(side: int) -> list:
    """SDXL's six time ids for an image of ``side``²: the base pipeline's
    defaults (original size, crop corner (0, 0), target size)."""
    return [side, side, 0, 0, side, side]


REFUSED = "--sd_version {version} does not support {what}"
WEIGHTS_WAIT = ("--sd_version flux-dev: --sd_weights cannot load yet; the loader "
                "waits for FLUX.1-dev's transformer, VAE, T5 and CLIP files (and "
                "T5's SentencePiece model) in a local directory")


def refused(sd_version, what: str) -> ValueError:
    """The error of a path that SDXL or FLUX does not support."""
    return ValueError(REFUSED.format(version=sd_version, what=what))


class StableDiffusionGuidance:
    """``dtype`` ("float32" | "bfloat16") is the JAX signature's compute
    dtype; ``None`` takes :func:`sd_dtype`'s rule.  Where the JAX package
    forces f32 on a CPU whatever it is given, an explicit ``dtype`` stands
    here, so that the bf16 stack can be held against the JAX modules on a
    CPU.  ``unet_cfg=None`` / ``vae_cfg=None`` take ``--sd_version``'s
    (:func:`unet_config`, :func:`vae_config`); ``device="meta"`` builds the
    modules' shapes only (no weights)."""

    def __init__(self, opt, device=None, unet_cfg: UNetConfig | None = None,
                 vae_cfg: VAEConfig | None = None, text_encoder=None,
                 dtype: str | None = None):
        if not opt.sd_weights and (opt.pretrained and not opt.test
                                   and not opt.allow_random_guidance):
            # a 10k-iter semantic run must not silently distill noise
            raise RuntimeError(RANDOM_WEIGHTS_ERROR)
        self.opt = opt
        self.family = sd_family(opt.sd_version)
        if self.family in ("xl", "flux") and opt.use_cd is not None and not opt.test:
            raise refused(opt.sd_version, "--use_cd (Custom Diffusion)")
        if self.family == "flux" and opt.sd_weights:
            raise NotImplementedError(WEIGHTS_WAIT)
        # the denoiser's device span in the editing step
        self.span = "dit" if self.family == "flux" else "unet"
        self.device = resolve_device(device)
        self.dtype = dtype or sd_dtype(self.device)
        unet_cfg = dataclasses.replace(unet_cfg or unet_config(opt.sd_version),
                                       dtype=self.dtype)
        vae_cfg = dataclasses.replace(vae_cfg or vae_config(opt.sd_version),
                                      dtype=self.dtype)
        t0 = time.time()
        with spans.span("guidance_build", counter="guidance_build"):
            self._build(opt, unet_cfg, vae_cfg, text_encoder)
        self.init_seconds = time.time() - t0

        self.scheduler = DDPMSchedule(device=self.device)
        self.num_train_timesteps = self.scheduler.num_train_timesteps
        self.min_step = int(self.num_train_timesteps * 0.02)
        self.max_step = int(self.num_train_timesteps * opt.max_ratio)
        self.alphas = self.scheduler.alphas_cumprod
        # the text-time conditioning's time ids (None without it)
        self.time_ids = None
        if getattr(unet_cfg, "addition_embed_type", None) is not None:
            self.time_ids = torch.tensor(time_ids(vae_cfg.sample_size),
                                         dtype=torch.float32, device=self.device)

    def _build(self, opt, unet_cfg, vae_cfg, text_encoder):
        """The models, their weights (drawn or loaded), the adapters and the
        storage cast."""
        gen = (None if self.device.type == "meta" else
               torch.Generator(device=self.device).manual_seed(int(opt.seed)))
        flux = self.family == "flux"
        # FLUX's transformer and T5 are stored in their dtype from the draw
        # on (no f32 copy of either); SD's models after their weights load
        store = unet_cfg.compute_dtype if flux else None
        self.unet = build(FluxTransformer if flux else UNet2DCondition, unet_cfg,
                          device=self.device, generator=gen,
                          dtype=store).eval().requires_grad_(False)
        self.vae = build(AutoencoderKL, vae_cfg, device=self.device,
                         generator=gen).eval().requires_grad_(False)
        self.text_encoder = text_encoder or make_text_encoder(
            opt.sd_version, weights_dir=opt.sd_weights, device=self.device,
            generator=gen, dtype=store)
        if flux:
            self.flux_guidance = torch.full((1,), FLUX_GUIDANCE, device=self.device)
        self.text_encoder.model.eval().requires_grad_(False)
        width = self.text_encoder.width
        if width != unet_cfg.cross_attention_dim:
            raise ValueError(
                f"--sd_version {opt.sd_version}: the text tower is {width} wide, "
                f"the UNet's context {unet_cfg.cross_attention_dim}")
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

    def load_cd(self, model_dir: str) -> dict:
        """``--use_cd``: the artifact pair in ``model_dir`` → ``self.cd_kv``
        (None without adapter weights) and its tokens registered on the text
        encoder; returns {token: embedding}."""
        if self.family in ("xl", "flux"):
            raise refused(self.opt.sd_version, "--use_cd (Custom Diffusion)")
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
        """[uncond; cond]: a tensor, or for xl a ``text.PooledText``; for
        flux-dev the prompt's ``PooledText`` alone."""
        return self.text_encoder.get_text_embeds(prompt, negative_prompt)

    def added_cond(self, pooled):
        """The UNet's "text_time" conditioning for pooled embeddings [B, P]
        (None without it, where ``pooled`` must be None too)."""
        if (pooled is None) != (self.time_ids is None):
            raise ValueError("the pooled text embedding goes with the text-time "
                             f"UNet alone (--sd_version {self.opt.sd_version})")
        if pooled is None:
            return None
        return {"text_embeds": pooled,
                "time_ids": self.time_ids.expand(pooled.shape[0], -1)}

    # --------------------------------------------------------------- image
    def encode_imgs(self, images, generator=None, noise=None):
        """images [B, 3, H, W] in [0, 1] → latents [B, C, H/8, W/8] (C the
        VAE's latent channels: 4, FLUX's 16), with the graph to the images."""
        return self.vae.encode(2.0 * images - 1.0, generator=generator,
                               noise=noise)

    # ----------------------------------------------------------------- SDS
    @torch.no_grad()
    def sds_grad(self, latents, text_embeddings, t, noise, pooled=None):
        """dL_sds/dlatents and the loss value 0.5·Σ grad², for latents
        [1, C, h, w], text_embeddings [uncond; cond] and noise ε, all f32, at
        timestep ``t`` (a [1] int64 tensor on the latents' device, or an
        int); for xl ``pooled`` [uncond; cond] [2, P]; for flux-dev the
        prompt's context [1, T, 4096] and pooled [1, 768]; the denoiser
        casts its inputs, and the gradient is formed in f32 from its f32
        output (the JAX ``sds_loss_fn``).  Nothing here reads t on the
        host."""
        grad, loss = self.sds_grad_batch(latents, text_embeddings[None], t, noise,
                                         None if pooled is None else pooled[None])
        return grad, loss[0]

    @torch.no_grad()
    def sds_grad_batch(self, latents, text_embeddings, t, noise, pooled=None):
        """:meth:`sds_grad` of S scenes through ONE UNet call of batch 2S
        (the JAX ``editing.py:545-552`` vmapped ε-prediction): latents and
        noise [S, 4, h, w], text_embeddings [S, 2, 77, C] (each scene's
        [uncond; cond]), for xl pooled [S, 2, P], t [S] int64 (or an int).
        The UNet's batch is [all S noisy; all S noisy] against [all S
        uncond; all S cond].  Returns grad [S, 4, h, w] and the loss values
        [S]."""
        if self.family == "flux":
            return self.flow_grad_batch(latents, text_embeddings[:, 0], t, noise,
                                        pooled[:, 0])
        S = latents.shape[0]
        t = torch.as_tensor(t, device=latents.device).reshape(-1).expand(S)
        noisy = self.scheduler.add_noise(latents, noise, t)
        latent_in = torch.cat([noisy, noisy])
        context = torch.cat([text_embeddings[:, 0], text_embeddings[:, 1]])
        added = self.added_cond(None if pooled is None
                                else torch.cat([pooled[:, 0], pooled[:, 1]]))
        eps_uncond, eps_text = self.unet(latent_in, torch.cat([t, t]), context,
                                         cd_kv=self.cd_kv, added_cond=added).chunk(2)
        eps_hat = eps_text + self.opt.cfg * (eps_text - eps_uncond)
        w = (1.0 - self.alphas.index_select(0, t)).reshape(S, 1, 1, 1)
        grad = torch.nan_to_num(w * (eps_hat.float() - noise) * self.opt.lambda_sd)
        return grad, 0.5 * (grad ** 2).reshape(S, -1).sum(dim=1)

    @torch.no_grad()
    def flow_grad_batch(self, latents, context, t, noise, pooled):
        """FLUX.1-dev's SDS gradient (module docstring) of S scenes in one
        transformer call of batch S: latents and noise [S, C, h, w], context
        [S, T, 4096], pooled [S, 768], t [S] int64 (or an int).  Returns
        grad [S, C, h, w] and the loss values [S]."""
        S, _, h, w = latents.shape
        t = torch.as_tensor(t, device=latents.device).reshape(-1).expand(S)
        sigma = flow_sigma(t, (h // 2) * (w // 2))
        s = sigma.reshape(S, 1, 1, 1)
        noisy = (1.0 - s) * latents + s * noise
        v = self.unet(noisy, sigma, context, pooled, self.flux_guidance.expand(S))
        eps_hat = noisy + (1.0 - s) * v.float()
        weight = s * s / ((1.0 - s) ** 2 + s * s)
        grad = torch.nan_to_num(weight * (eps_hat - noise) * self.opt.lambda_sd)
        return grad, 0.5 * (grad ** 2).reshape(S, -1).sum(dim=1)

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
