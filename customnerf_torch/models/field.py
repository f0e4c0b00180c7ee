"""The tri-plane NeRF field with a foreground-confidence channel
(counterpart of ``customnerf_tpu/models/field.py``).

Default fused head, all bias-free and 64 wide (tcnn FullyFusedMLP parity):
``feature_net`` (2 hidden ReLU layers + linear out), ``density_net``
(Dense-ReLU-Dense → 1) and ``rgb_net`` on ``[view_en ‖ fea]`` with 3 + conf
sigmoid outputs.  σ = trunc_exp(density_raw + gaussian_blob(x)).

Every evaluation goes through :func:`fused_field_mlp` — the counterpart of
``make_pallas_apply`` (``field.py:193-239``): on the card the hand-written
fused-MLP kernel, on the CPU its plain version.  Parameter names follow the
flax tree (``feature_net.hidden_0.weight`` ↔ ``feature_net/hidden_0/kernel``)
so ``engine/convert.py`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import torch
from torch import nn

from customnerf_torch.ops.activations import trunc_exp
from customnerf_torch.ops.frequency import freq_encode, freq_encode_dim
from customnerf_torch.ops.fused_mlp import fused_field_mlp
from customnerf_torch.ops.triplane import (TriplaneSpec, triplane_encode,
                                           triplane_init)


@dataclass(frozen=True)
class FieldConfig:
    bound: float = 2.0
    grid: TriplaneSpec = dc_field(default_factory=TriplaneSpec)
    dir_multires: int = 4
    hidden: int = 64
    train_conf: bool = True
    conf_channels: int = 1            # 2 when keyword2 is set
    detach_mask_from_field: bool = False
    mask_no_dir: bool = False
    mask_no_dir_nodetach: bool = False
    use_bias: bool = False

    @property
    def dir_dim(self) -> int:
        return freq_encode_dim(self.dir_multires)


class MLP(nn.Module):
    """Bias-free ReLU MLP: ``hidden_0 … hidden_{n-1}``, ``out``."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int, n_hidden: int):
        super().__init__()
        dims = [in_dim] + [hidden] * n_hidden
        for i in range(n_hidden):
            self.add_module(f"hidden_{i}", nn.Linear(dims[i], hidden, bias=False))
        self.out = nn.Linear(dims[-1], out_dim, bias=False)
        self.n_hidden = n_hidden

    def kernels(self):
        """[in, out] matrices in layer order (the flax Dense.kernel layout)."""
        layers = [getattr(self, f"hidden_{i}") for i in range(self.n_hidden)]
        return [l.weight.t().contiguous() for l in layers + [self.out]]


def _variant_error(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported yet (ROADMAP.md queue A, item 'field variants')")


class NeRFField(nn.Module):
    """Tri-plane field with the default fused rgb + conf head."""

    def __init__(self, cfg: FieldConfig, seed: int = 0, device=None):
        super().__init__()
        if cfg.use_bias:
            raise _variant_error("--mlp_bias")
        if cfg.detach_mask_from_field:
            raise _variant_error("--detach_mask_from_field")
        if cfg.mask_no_dir or cfg.mask_no_dir_nodetach:
            raise _variant_error("--mask_no_dir")
        if not cfg.train_conf:
            raise _variant_error("--train_conf 0 (rgb head without conf)")
        if cfg.hidden != 64:
            raise ValueError("the fused head is 64 wide")
        self.cfg = cfg
        h = cfg.hidden
        # initialised on the CPU from one seeded generator, then moved: the
        # same seed gives the same field on every device
        gen = torch.Generator().manual_seed(int(seed))
        self.grid_table = nn.Parameter(triplane_init(cfg.grid, generator=gen))
        self.feature_net = MLP(cfg.grid.output_dim, h, h, 2)
        self.density_net = MLP(h, 1, h, 1)
        self.rgb_net = MLP(cfg.dir_dim + h, 3 + cfg.conf_channels, h, 1)
        self._init_mlps(gen)
        self.to(device)

    @torch.no_grad()
    def _init_mlps(self, gen):
        # close to the flax Dense default (LeCun normal truncated at ±2σ):
        # a normal clipped at ±2σ, scaled by the same truncation factor
        for mod in (self.feature_net, self.density_net, self.rgb_net):
            for lin in mod.children():
                std = lin.weight.shape[1] ** -0.5 / 0.87962566103423978
                w = torch.randn(lin.weight.shape, generator=gen)
                lin.weight.copy_(torch.clamp(w, -2.0, 2.0) * std)

    @staticmethod
    def gaussian_blob(x):
        """Density blob at the scene centre (network_grid.py:150-156)."""
        d = (x * x).sum(dim=-1)
        return 5.0 * torch.exp(-d / (2.0 * 0.2 ** 2))

    def weights(self):
        """The seven head matrices in the fused kernel's order and layout."""
        return (self.feature_net.kernels() + self.density_net.kernels()
                + self.rgb_net.kernels())

    def _encode(self, x):
        """x [..., 3] → (flattened x [N, 3], x_en [N, grid.output_dim])."""
        c = self.cfg
        xf = x.reshape(-1, 3)
        x01 = (xf + c.bound) / (2.0 * c.bound)
        return xf, triplane_encode(x01, self.grid_table, c.grid).contiguous()

    def forward(self, x, d):
        """x, d: [..., 3] positions / view directions → (sigma [...],
        radiance [..., 3 + conf_channels])."""
        prefix = x.shape[:-1]
        xf, x_en = self._encode(x)
        view_en = freq_encode(d.reshape(-1, 3), self.cfg.dir_multires)
        sigma_raw, rgb_raw = fused_field_mlp(x_en, view_en.contiguous(),
                                             self.weights())
        sigma = trunc_exp(sigma_raw + self.gaussian_blob(xf))
        radiance = torch.sigmoid(rgb_raw)
        return sigma.reshape(prefix), radiance.reshape(*prefix, radiance.shape[-1])

    def density(self, x):
        """x: [..., 3] world coords → sigma [...].  The fused kernel without
        its rgb head: the same sigma as ``make_pallas_apply``'s density,
        which runs the full head on zero directions."""
        xf, x_en = self._encode(x)
        sigma_raw, _ = fused_field_mlp(x_en, None, self.weights(), with_rgb=False)
        return trunc_exp(sigma_raw + self.gaussian_blob(xf)).reshape(x.shape[:-1])


def param_groups(field: NeRFField):
    """('grid', [grid_table]) and ('mlp', [the rest]) — the encoder trains
    at lr×10 (reference network_grid.py:196-206)."""
    grid = [field.grid_table]
    mlp = [p for n, p in field.named_parameters() if n != "grid_table"]
    return {"grid": grid, "mlp": mlp}
