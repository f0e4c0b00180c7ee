"""Carry weights and occupancy state between the JAX package's trees and the
port's modules, as plain numpy (no JAX import here).

The flax field tree is ``{"params": {"grid_table": [T, C],
"feature_net": {"hidden_0": {"kernel": [in, out]}, …}, …}}``.  Two traps:
flax ``Dense.kernel`` is ``[in, out]`` while ``nn.Linear.weight`` is
``[out, in]``; and ``rgb_net.hidden_0`` takes ``[view_en(27) ‖ fea(64)]`` in
that order — the port's field keeps the same order, so rows map 1:1.  The
variants' ``conf_net`` and ``--mlp_bias``'s biases map by the same names
(``conf_net.out.bias`` ↔ ``conf_net/out/bias``).

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

_NETS = ("feature_net", "density_net", "rgb_net", "conf_net")


def params_from_flax(tree) -> dict:
    """Flax param tree (numpy leaves, with or without the outer "params")
    → a ``NeRFField`` state dict of float32 CPU tensors.  Leaves stacked on
    leading axes (multi-scene editing's scene axis) keep them."""
    p = tree["params"] if "params" in tree else tree
    sd = {"grid_table": torch.tensor(np.asarray(p["grid_table"], np.float32))}
    for net in _NETS:
        for layer, leaves in p.get(net, {}).items():
            k = np.asarray(leaves["kernel"], np.float32)
            sd[f"{net}.{layer}.weight"] = torch.tensor(np.swapaxes(k, -1, -2).copy())
            if "bias" in leaves:
                sd[f"{net}.{layer}.bias"] = torch.tensor(
                    np.asarray(leaves["bias"], np.float32))
    return sd


def flax_path(name: str) -> tuple:
    """A ``NeRFField`` state-dict name → its path in the flax tree
    (``feature_net.hidden_0.weight`` → ``params/feature_net/hidden_0/kernel``)."""
    if name == "grid_table":
        return ("params", "grid_table")
    net, layer, leaf = name.split(".")
    return ("params", net, layer, "kernel" if leaf == "weight" else "bias")


def params_to_flax(state_dict, copy: bool = True) -> dict:
    """``NeRFField`` state dict → ``{"params": …}`` tree of numpy arrays
    (stacked state dicts → stacked leaves).  ``copy=False`` keeps views of
    CPU tensors where no transpose is needed (C-contiguous either way)."""
    tree: dict = {}
    for key, value in state_dict.items():
        a = value.detach().cpu().numpy()
        if key != "grid_table" and key.endswith(".weight"):
            a = np.swapaxes(a, -1, -2)
        *parents, leaf = flax_path(key)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a.copy() if copy else np.ascontiguousarray(a)
    return tree


def flax_shapes(state_dict) -> dict:
    """Dotted flax path → shape of each entry of a ``NeRFField`` state
    dict (what ``engine/pytreedef.py::optax_layout`` takes), without its
    data."""
    out = {}
    for key, value in state_dict.items():
        shape = tuple(value.shape)
        if key != "grid_table" and key.endswith(".weight"):
            shape = shape[:-2] + shape[:-3:-1]
        out[".".join(flax_path(key))] = shape
    return out


def adam_to_torch(adam: dict, names, param_groups) -> dict:
    """The port's Adam (``step``; ``exp_avg`` / ``exp_avg_sq`` by parameter
    name) → a ``torch.optim.Adam`` state dict whose parameter i is
    ``names[i]``, with ``param_groups`` (the optimizer's own)."""
    state = {i: {"step": adam["step"].clone(),
                 "exp_avg": adam["exp_avg"][n].clone(),
                 "exp_avg_sq": adam["exp_avg_sq"][n].clone()}
             for i, n in enumerate(names)}
    return {"state": state, "param_groups": param_groups}


def adam_from_torch(state_dict: dict, names, params: dict) -> dict:
    """A ``torch.optim.Adam`` state dict (parameter i is ``names[i]``) →
    ``{"exp_avg", "exp_avg_sq"}`` by parameter name; a parameter without
    state (no update yet) has zero moments shaped as ``params[name]``."""
    st = state_dict["state"]

    def moment(k):
        return {n: st[i][k] if i in st else torch.zeros_like(params[n])
                for i, n in enumerate(names)}

    return {"exp_avg": moment("exp_avg"), "exp_avg_sq": moment("exp_avg_sq")}


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _adam_states(node):
    """The ``ScaleByAdamState``-like nodes (``count``, ``mu``, ``nu``) of an
    optax state, in order (one a label of ``multi_transform``)."""
    if {"mu", "nu"} <= set(getattr(node, "_fields", ())):
        return [node]
    if isinstance(node, dict):
        return [a for v in node.values() for a in _adam_states(v)]
    if isinstance(node, (tuple, list)):
        return [a for v in node for a in _adam_states(v)]
    return []


def _merge_masked(trees):
    """One tree from the per-label trees of ``multi_transform``, each
    holding arrays where its label applies (a masked node elsewhere)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _merge_masked([t[k] for t in trees]) for k in first}
    arrays = [t for t in trees if _is_array(t)]
    if len(arrays) != 1:
        raise ValueError(f"a leaf held by {len(arrays)} of the optax labels")
    return arrays[0]


def adam_from_optax(opt_state) -> dict:
    """The JAX trainer's optax state (``multi_transform`` of zero_nans →
    Adam → lr schedule, numpy leaves, optionally stacked on a scene axis)
    → the port's ``{"step", "exp_avg", "exp_avg_sq"}`` with the field's
    parameter names (``step`` f32 on the CPU: the update count, the
    ``count`` of optax's Adam and schedule)."""
    states = _adam_states(opt_state)
    if not states:
        raise ValueError("no Adam state in the optax state")
    counts = [np.asarray(a.count) for a in states]
    if any(not np.array_equal(c, counts[0]) for c in counts):
        raise ValueError("the optax labels' Adam counts differ")
    return {"step": torch.tensor(counts[0].astype(np.float32)),
            "exp_avg": params_from_flax(_merge_masked([a.mu for a in states])),
            "exp_avg_sq": params_from_flax(_merge_masked([a.nu for a in states]))}


def adam_to_optax(adam: dict, template):
    """:func:`adam_from_optax` inverted into the structure of ``template``
    (an optax state of the same field): its moments, and every ``count``
    (Adam's and the schedule's) set to ``step``; masked nodes stay."""
    mu = params_to_flax(adam["exp_avg"])
    nu = params_to_flax(adam["exp_avg_sq"])
    count = adam["step"].detach().cpu().numpy().astype(np.int32)

    def fill(node, full):
        if isinstance(node, dict):
            return {k: fill(v, full[k]) for k, v in node.items()}
        return full if _is_array(node) else node

    def walk(node):
        fields = getattr(node, "_fields", ())
        if "mu" in fields and "nu" in fields:
            return node._replace(count=count, mu=fill(node.mu, mu), nu=fill(node.nu, nu))
        if "count" in fields:
            return node._replace(count=count)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*[walk(v) for v in node])
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(template)


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
