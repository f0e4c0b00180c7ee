"""Carry weights and occupancy state between the JAX package's trees and the
port's modules, as plain numpy (no JAX import here).

The flax field tree is ``{"params": {"grid_table": [T, C],
"feature_net": {"hidden_0": {"kernel": [in, out]}, …}, …}}``.  Two traps:
flax ``Dense.kernel`` is ``[in, out]`` while ``nn.Linear.weight`` is
``[out, in]``; and ``rgb_net.hidden_0`` takes ``[view_en(27) ‖ fea(64)]`` in
that order — the port's field keeps the same order, so rows map 1:1.

:func:`state_from_flax` carries the SD guidance across: the JAX package's
UNet and VAE trees (flat module names such as ``down_0_resnet_1``) and
transformers-Flax CLIP trees become the port's state dicts, whose keys are
diffusers' and Hugging Face's — the inverse of the renaming in the JAX
package's ``guidance/weights.py``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from customnerf_torch.ops.occupancy import OccupancyState

_LAYERS = {
    "feature_net": ("hidden_0", "hidden_1", "out"),
    "density_net": ("hidden_0", "out"),
    "rgb_net": ("hidden_0", "out"),
}


def params_from_flax(tree) -> dict:
    """Flax param tree (numpy leaves, with or without the outer "params")
    → a ``NeRFField`` state dict of float32 CPU tensors."""
    p = tree["params"] if "params" in tree else tree
    sd = {"grid_table": torch.tensor(np.asarray(p["grid_table"], np.float32))}
    for net, layers in _LAYERS.items():
        for layer in layers:
            if "bias" in p[net][layer]:
                raise NotImplementedError("biased heads are not ported yet")
            k = np.asarray(p[net][layer]["kernel"], np.float32)
            sd[f"{net}.{layer}.weight"] = torch.tensor(k.T.copy())
    return sd


def params_to_flax(state_dict) -> dict:
    """``NeRFField`` state dict → ``{"params": …}`` tree of numpy arrays."""
    p = {"grid_table": state_dict["grid_table"].detach().cpu().numpy().copy()}
    for net, layers in _LAYERS.items():
        p[net] = {layer: {"kernel": state_dict[f"{net}.{layer}.weight"]
                          .detach().cpu().numpy().T.copy()}
                  for layer in layers}
    return {"params": p}


# flax module names of the SD UNet / VAE (customnerf_tpu/guidance/unet.py,
# vae.py) → diffusers' state-dict paths: the inverse of the renaming in the
# JAX package's guidance/weights.py convert_unet / convert_vae
_SD_NAMES = [
    (re.compile(r"^(down|up)_(\d+)_resnet_(\d+)$"), r"\1_blocks.\2.resnets.\3"),
    (re.compile(r"^(down|up)_(\d+)_attn_(\d+)$"), r"\1_blocks.\2.attentions.\3"),
    (re.compile(r"^(down|up)_(\d+)_(down|up)sample$"), r"\1_blocks.\2.\3samplers.0"),
    (re.compile(r"^mid_(resnet|attn)_(\d+)$"), None),
    (re.compile(r"^transformer_blocks_(\d+)$"), r"transformer_blocks.\1"),
    (re.compile(r"^to_out_0$"), "to_out.0"),
    (re.compile(r"^net_0_proj$"), "net.0.proj"),
    (re.compile(r"^net_2$"), "net.2"),
]
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _module_name(name: str) -> str:
    for pat, rep in _SD_NAMES:
        m = pat.match(name)
        if not m:
            continue
        if rep is None:          # mid_resnet_0 → mid_block.resnets.0
            kind = "resnets" if m.group(1) == "resnet" else "attentions"
            return f"mid_block.{kind}.{m.group(2)}"
        return m.expand(rep)
    return name


def state_from_flax(tree) -> dict:
    """A flax / transformers-Flax param tree of the SD UNet, the VAE, the
    CLIP text model or the CLIP ViT-B/32 model (numpy leaves, with or
    without the outer "params") → the port module's state dict.  Conv
    kernels go HWIO → OIHW, Dense kernels [in, out] → [out, in]; norm scales
    and embeddings become ``weight``."""
    tree = tree["params"] if "params" in tree else tree
    sd = {}

    def walk(path, node):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(path + [str(k)], v)
            return
        a = np.asarray(node, np.float32)
        *mods, leaf = path
        names = [_module_name(m) for m in mods]
        if leaf == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            a = a.T
        if mods and mods[-1].endswith("sample") and leaf in ("kernel", "bias"):
            names.append("conv")     # the VAE's samplers are bare convs
        key = ".".join(names + [_LEAF_NAMES.get(leaf, leaf)])
        sd[key] = torch.tensor(np.ascontiguousarray(a))

    walk([], tree)
    return sd


def occupancy_from_numpy(density_grid, bitfield, mean_density, iter_density,
                         grid_size: int, device=None) -> OccupancyState:
    """Numpy arrays of an ``OccupancyState`` (e.g. the JAX package's, pulled
    to host) → the port's state on ``device``."""
    return OccupancyState(
        density_grid=torch.tensor(np.asarray(density_grid, np.float32),
                                  device=device),
        bitfield=torch.tensor(np.asarray(bitfield, np.uint8), device=device),
        mean_density=torch.tensor(float(np.asarray(mean_density)),
                                  dtype=torch.float32, device=device),
        iter_density=int(np.asarray(iter_density)),
        grid_size=int(grid_size),
    )
