"""``--sd_weights``: load a local diffusers-layout SD directory straight into
the port's modules (counterpart of ``customnerf_tpu/guidance/weights.py``).

The directory holds ``unet/diffusion_pytorch_model.bin``,
``vae/diffusion_pytorch_model.bin``, ``text_encoder/pytorch_model.bin`` and
``tokenizer/`` (the files the JAX loader looks for).  The port's modules
carry diffusers' and Hugging Face's names, so the UNet and text encoder load
with ``load_state_dict`` as they are, with one reshape: SD 2.x stores the
UNet's ``proj_in``/``proj_out`` as ``[C, C]`` linear weights
(``use_linear_projection``), which load into the 1×1-conv slot as
``[C, C, 1, 1]`` (:func:`unet_state`, the JAX package's
``weights.py:87-93``).  The VAE's older attention names
(``query/key/value/proj_attn``, some stored as 1×1 convs) are renamed.  The
2.x text encoder (OpenCLIP ViT-H, 23 layers) loads through the same keys
as 1.x's.  An SDXL base directory (``--sd_version xl``) adds
``text_encoder_2/`` (OpenCLIP ViT-bigG with its ``text_projection``) and
``tokenizer_2/``; its UNet's ``proj_in``/``proj_out`` are linear, reshaped
as 2.x's, and each tower loads into its slot of ``text.SDXLTextTowers``.
``.safetensors`` files need the ``safetensors`` package and are refused
without it.  A sub-model without a file keeps its random weights, with a
warning, as in the JAX package.  The files are read as f32 and each tensor
is cast to its parameter's dtype as it loads: the guidance loads them into
its f32 modules before its storage cast (``sds.py``), as the JAX package
casts after ``load_sd_weights``, and a module already stored in bf16 takes
them rounded.
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


def unet_state(src: dict) -> dict:
    """Reshape SD 2.x's linear ``proj_in``/``proj_out`` weights ``[C, C]``
    to the 1×1 convs' ``[C, C, 1, 1]``; SD 1.x's conv weights pass as they
    are."""
    out = {}
    for k, v in src.items():
        parts = k.split(".")
        if "attentions" in parts and parts[-2] in ("proj_in", "proj_out") \
                and parts[-1] == "weight" and v.ndim == 2:
            v = v[:, :, None, None]
        out[k] = v
    return out


def _load_into(module, state: dict, what: str, path: str):
    have = module.state_dict()
    module.load_state_dict({k: v.to(have[k].device, have[k].dtype) if k in have else v
                            for k, v in state.items()})
    print(f"[INFO] loaded {what} weights from {path}")


def _keep_added_rows(model, state: dict):
    """A token table grown by added modifier tokens (``text.register_token``)
    keeps its added rows when a 49408-row table loads into it."""
    key = "text_model.embeddings.token_embedding.weight"
    have = model.state_dict()[key]
    if key in state and state[key].shape[0] < have.shape[0]:
        state[key] = torch.cat([state[key], have[state[key].shape[0]:].cpu()])


def load_sd_weights(guidance, weights_dir: str):
    """Fill ``guidance.unet``, ``guidance.vae`` and the text encoder (for
    SDXL both towers) from ``weights_dir``."""
    names = ("diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors")
    unet_path = _find(os.path.join(weights_dir, "unet"), *names)
    if unet_path:
        _load_into(guidance.unet, unet_state(load_torch_state(unet_path)), "UNet",
                   unet_path)
    else:
        print(f"[WARN] no UNet weights under {weights_dir}/unet — random init.")
    vae_path = _find(os.path.join(weights_dir, "vae"), *names)
    if vae_path:
        _load_into(guidance.vae, vae_state(load_torch_state(vae_path)), "VAE",
                   vae_path)
    else:
        print(f"[WARN] no VAE weights under {weights_dir}/vae — random init.")
    towers = guidance.text_encoder.model
    if hasattr(towers, "text_encoder_2"):           # SDXL: two towers
        slots = [("text_encoder", towers.text_encoder),
                 ("text_encoder_2", towers.text_encoder_2)]
    else:
        slots = [("text_encoder", towers)]
    for sub, model in slots:
        te_path = _find(os.path.join(weights_dir, sub), "pytorch_model.bin",
                        "model.safetensors")
        if te_path:
            state = {k: v for k, v in load_torch_state(te_path).items()
                     if not k.endswith("position_ids")}
            _keep_added_rows(model, state)
            _load_into(model, state, sub.replace("_", " "), te_path)
        else:
            print(f"[WARN] no text encoder under {weights_dir}/{sub} — random init.")
