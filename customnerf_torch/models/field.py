"""The tri-plane NeRF field with a foreground-confidence channel
(counterpart of ``customnerf_tpu/models/field.py``).

Default fused head, all bias-free and 64 wide (tcnn FullyFusedMLP parity):
``feature_net`` (2 hidden ReLU layers + linear out), ``density_net``
(Dense-ReLU-Dense → 1) and ``rgb_net`` on ``[view_en ‖ fea]`` with 3 + conf
sigmoid outputs.  σ = trunc_exp(density_raw + gaussian_blob(x)).

The default head goes through :func:`fused_field_mlp` — the counterpart of
``make_pallas_apply`` (``field.py:193-239``): on the card the hand-written
fused-MLP kernel, on the CPU its plain version.  The variants of
``field.py:123-184`` take plain PyTorch heads, as the JAX package takes its
flax heads for them (``make_pallas_apply`` covers the default head only):

  * ``use_bias`` (``--mlp_bias``): every Dense layer with a bias;
  * ``detach_mask_from_field``: an rgb net with 3 outputs and a separate
    ``conf_net`` on the *detached* rgb-net input ``[view_en ‖ fea]``;
  * ``mask_no_dir``: the ``conf_net`` on the 64-d feature alone, detached
    unless ``mask_no_dir_nodetach``;
  * ``train_conf`` off: an rgb net with 3 outputs and no conf channel.

Parameter names follow the flax tree (``feature_net.hidden_0.weight`` ↔
``feature_net/hidden_0/kernel``) so ``engine/convert.py`` maps one onto the
other.
"""

from __future__ import annotations

import math
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
    """ReLU MLP: ``hidden_0 … hidden_{n-1}``, ``out``; bias-free unless
    ``use_bias`` (tcnn's FullyFusedMLP has none)."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int, n_hidden: int,
                 use_bias: bool = False):
        super().__init__()
        dims = [in_dim] + [hidden] * n_hidden
        for i in range(n_hidden):
            self.add_module(f"hidden_{i}", nn.Linear(dims[i], hidden, bias=use_bias))
        self.out = nn.Linear(dims[-1], out_dim, bias=use_bias)
        self.n_hidden = n_hidden

    def layers(self):
        return [getattr(self, f"hidden_{i}") for i in range(self.n_hidden)] + [self.out]

    def kernels(self):
        """[in, out] matrices in layer order (the flax Dense.kernel layout)."""
        return [l.weight.t().contiguous() for l in self.layers()]

    def forward(self, x):
        *hidden, out = self.layers()
        for layer in hidden:
            x = torch.relu(layer(x))
        return out(x)


class NeRFField(nn.Module):
    """Tri-plane field: the default fused rgb + conf head, or a variant's
    plain heads (``fused`` tells which)."""

    def __init__(self, cfg: FieldConfig, seed: int = 0, device=None):
        super().__init__()
        if cfg.hidden != 64:
            raise ValueError("the fused head is 64 wide")
        self.cfg = cfg
        h, bias = cfg.hidden, cfg.use_bias
        split_conf = cfg.detach_mask_from_field or cfg.mask_no_dir
        self.fused = cfg.train_conf and not split_conf and not bias
        # initialised on the CPU from one seeded generator, then moved: the
        # same seed gives the same field on every device
        gen = torch.Generator().manual_seed(int(seed))
        self.grid_table = nn.Parameter(triplane_init(cfg.grid, generator=gen))
        self.feature_net = MLP(cfg.grid.output_dim, h, h, 2, bias)
        self.density_net = MLP(h, 1, h, 1, bias)
        rgb_out = 3 + (cfg.conf_channels if cfg.train_conf and not split_conf else 0)
        self.rgb_net = MLP(cfg.dir_dim + h, rgb_out, h, 1, bias)
        self.conf_net = None
        if cfg.train_conf and split_conf:
            conf_in = h if cfg.mask_no_dir else cfg.dir_dim + h
            self.conf_net = MLP(conf_in, cfg.conf_channels, h, 1, bias)
        self._init_mlps(gen)
        self.to(device)

    def _mlps(self):
        return [m for m in (self.feature_net, self.density_net, self.rgb_net,
                            self.conf_net) if m is not None]

    @torch.no_grad()
    def _init_mlps(self, gen):
        # the flax Dense default, LeCun normal: a normal truncated to ±2σ
        # (drawn by inverting its CDF) with variance 1/fan_in; biases start
        # at zero, as flax's do.  A normal clipped at ±2σ instead has 24 %
        # more variance, and trained the bear fixture measurably worse
        # (PERF.md, Findings).
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        for mod in self._mlps():
            for lin in mod.layers():
                std = lin.weight.shape[1] ** -0.5 / 0.87962566103423978
                u = lo + (1.0 - 2.0 * lo) * torch.rand(lin.weight.shape, generator=gen,
                                                       dtype=torch.float64)
                w = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
                lin.weight.copy_(torch.clamp(w, -2.0, 2.0) * std)
                if lin.bias is not None:
                    lin.bias.zero_()

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

    def _plain_heads(self, x_en, view_en):
        """The variants' heads (``field.py:167-185``) → (sigma_raw [N],
        radiance [N, R] after its sigmoids)."""
        c = self.cfg
        fea = self.feature_net(x_en)
        sigma_raw = self.density_net(fea)[..., 0]
        rgb_in = torch.cat([view_en, fea], dim=-1)
        radiance = torch.sigmoid(self.rgb_net(rgb_in))
        if self.conf_net is not None:
            if c.mask_no_dir:
                conf_in = fea if c.mask_no_dir_nodetach else fea.detach()
            else:
                conf_in = rgb_in.detach()
            radiance = torch.cat([radiance, torch.sigmoid(self.conf_net(conf_in))], -1)
        return sigma_raw, radiance

    def forward(self, x, d):
        """x, d: [..., 3] positions / view directions → (sigma [...],
        radiance [..., 3 (+ conf_channels when train_conf)])."""
        prefix = x.shape[:-1]
        xf, x_en = self._encode(x)
        view_en = freq_encode(d.reshape(-1, 3), self.cfg.dir_multires)
        if self.fused:
            sigma_raw, rgb_raw = fused_field_mlp(x_en, view_en.contiguous(),
                                                 self.weights())
            radiance = torch.sigmoid(rgb_raw)
        else:
            sigma_raw, radiance = self._plain_heads(x_en, view_en)
        sigma = trunc_exp(sigma_raw + self.gaussian_blob(xf))
        return sigma.reshape(prefix), radiance.reshape(*prefix, radiance.shape[-1])

    def density(self, x):
        """x: [..., 3] world coords → sigma [...].  The default head runs the
        fused kernel without its rgb part: the same sigma as
        ``make_pallas_apply``'s density, which runs the full head on zero
        directions."""
        xf, x_en = self._encode(x)
        if self.fused:
            sigma_raw, _ = fused_field_mlp(x_en, None, self.weights(), with_rgb=False)
        else:
            sigma_raw = self.density_net(self.feature_net(x_en))[..., 0]
        return trunc_exp(sigma_raw + self.gaussian_blob(xf)).reshape(x.shape[:-1])


def param_groups(field: NeRFField):
    """('grid', [grid_table]) and ('mlp', [the rest]) — the encoder trains
    at lr×10 (reference network_grid.py:196-206)."""
    grid = [field.grid_table]
    mlp = [p for n, p in field.named_parameters() if n != "grid_table"]
    return {"grid": grid, "mlp": mlp}
