"""``--sd_weights``: load a local diffusers-layout SD directory straight into
the port's modules (counterpart of ``customnerf_tpu/guidance/weights.py``).

The directory holds ``unet/diffusion_pytorch_model.bin``,
``vae/diffusion_pytorch_model.bin``, ``text_encoder/pytorch_model.bin`` and
``tokenizer/`` (the files the JAX loader looks for).  The port's modules
carry diffusers' and Hugging Face's names, so the UNet and text encoder load
with ``load_state_dict`` as they are; the VAE's older attention names
(``query/key/value/proj_attn``, some stored as 1×1 convs) are renamed.
``.safetensors`` files need the ``safetensors`` package and are refused
without it.  A sub-model without a file keeps its random weights, with a
warning, as in the JAX package.
"""

from __future__ import annotations

import os

import torch

_OLD_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                 "proj_attn": "to_out.0"}


def load_torch_state(path: str) -> dict:
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError("safetensors is not available; provide the "
                               ".bin files") from e
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def _find(dirpath: str, *names):
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    return None


def vae_state(src: dict) -> dict:
    """Rename the older diffusers VAE attention keys to the current ones and
    squeeze 1×1-conv attention weights to linear ones."""
    out = {}
    for k, v in src.items():
        parts = k.split(".")
        if "attentions" in parts and parts[-2] in _OLD_VAE_ATTN:
            parts[-2] = _OLD_VAE_ATTN[parts[-2]]
            k = ".".join(parts)
        if "attentions" in parts and v.ndim == 4:
            v = v[:, :, 0, 0]
        out[k] = v
    return out


def _load_into(module, state: dict, what: str, path: str):
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in state.items()})
    print(f"[INFO] loaded {what} weights from {path}")


def load_sd_weights(guidance, weights_dir: str):
    """Fill ``guidance.unet``, ``guidance.vae`` and the text encoder from
    ``weights_dir``."""
    names = ("diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors")
    unet_path = _find(os.path.join(weights_dir, "unet"), *names)
    if unet_path:
        _load_into(guidance.unet, load_torch_state(unet_path), "UNet", unet_path)
    else:
        print(f"[WARN] no UNet weights under {weights_dir}/unet — random init.")
    vae_path = _find(os.path.join(weights_dir, "vae"), *names)
    if vae_path:
        _load_into(guidance.vae, vae_state(load_torch_state(vae_path)), "VAE",
                   vae_path)
    else:
        print(f"[WARN] no VAE weights under {weights_dir}/vae — random init.")
    te_path = _find(os.path.join(weights_dir, "text_encoder"),
                    "pytorch_model.bin", "model.safetensors")
    if te_path:
        state = {k: v for k, v in load_torch_state(te_path).items()
                 if not k.endswith("position_ids")}
        _load_into(guidance.text_encoder.model, state, "text encoder", te_path)
    else:
        print(f"[WARN] no text encoder under {weights_dir}/text_encoder — "
              f"random init.")
