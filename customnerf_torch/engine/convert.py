"""Carry weights and occupancy state between the JAX package's trees and the
port's modules, as plain numpy (no JAX import here).

The flax field tree is ``{"params": {"grid_table": [T, C],
"feature_net": {"hidden_0": {"kernel": [in, out]}, …}, …}}``.  Two traps:
flax ``Dense.kernel`` is ``[in, out]`` while ``nn.Linear.weight`` is
``[out, in]``; and ``rgb_net.hidden_0`` takes ``[view_en(27) ‖ fea(64)]`` in
that order — the port's field keeps the same order, so rows map 1:1.
"""

from __future__ import annotations

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
