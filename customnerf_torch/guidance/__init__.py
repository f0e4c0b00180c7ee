"""Stable Diffusion 1.5 guidance for LGIE editing (counterpart of
``customnerf_tpu/guidance/``): UNet, VAE, CLIP text encoder and tokenizers,
the DDPM schedule, SDS, CLIP view matching and ``--sd_weights`` loading.

Modules are named after the diffusers / Hugging Face state-dict keys, so a
diffusers-layout weight directory loads with no renaming.  Every module
imports ``torch`` only."""
