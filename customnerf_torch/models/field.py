"""The grid NeRF field with a foreground-confidence channel (counterpart of
``customnerf_tpu/models/field.py``).

The position encoder follows the spec's type (``encode_positions``): the
reference's multiresolution tiled / hash grid (``GridSpec``, the default:
tiled, 16 levels × 2 channels at 2^21 rows and desired resolution 8192,
``network_grid.py:89-96``, a 32-wide feature) or the tri-plane
(``TriplaneSpec``, ``--grid_type triplane``).

Default fused head, all bias-free and 64 wide (tcnn FullyFusedMLP parity):
``feature_net`` (2 hidden ReLU layers + linear out), ``density_net``
(Dense-ReLU-Dense → 1) and ``rgb_net`` on ``[view_en ‖ fea]`` with 3 + conf
sigmoid outputs.  σ = trunc_exp(density_raw + gaussian_blob(x)).

The default head goes through :func:`fused_field_mlp`: on the card the
hand-written fused-MLP kernel, on the CPU its plain version.  Its mode
follows the JAX package's precision rules: ``compute_dtype="bfloat16"``
(the trainer's choice under ``fp16``, i.e. ``-O``/``-O2``) with
``backend="xla"`` runs the flax bf16 head (the kernel's bf16 mode, then the
sigmoid in bf16); otherwise the f32 mode, the counterpart of
``make_pallas_apply`` (``field.py:193-239``) under ``--backend pallas``.
The variants of ``field.py:123-184`` take plain PyTorch heads in
``compute_dtype``, as the JAX package takes its flax heads for them
(``make_pallas_apply`` covers the default head only); in bf16 each Dense
takes bf16 inputs and weights, sums in f32 and rounds its output to bf16,
and the sigmoids run in bf16 before the f32 cast (``field.py:84-106``;
``ops/activations.py::sigmoid_bf16``):

  * ``use_bias`` (``--mlp_bias``): every Dense layer with a bias;
  * ``detach_mask_from_field``: an rgb net with 3 outputs and a separate
    ``conf_net`` on the *detached* rgb-net input ``[view_en ‖ fea]``;
  * ``mask_no_dir``: the ``conf_net`` on the 64-d feature alone, detached
    unless ``mask_no_dir_nodetach``;
  * ``train_conf`` off: an rgb net with 3 outputs and no conf channel.

Parameter names follow the flax tree (``feature_net.hidden_0.weight`` ↔
``feature_net/hidden_0/kernel``) so ``engine/convert.py`` maps one onto the
other.  A seed gives the grid field the JAX package's initial field
(``init_params(PRNGKey(seed))``, reproduced by ``utils/threefry.py``); the
tri-plane field draws from one seeded ``torch.Generator`` (see
``NeRFField._draws``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.ops.activations import sigmoid_bf16, trunc_exp
from customnerf_torch.ops.frequency import freq_encode, freq_encode_dim
from customnerf_torch.ops.fused_mlp import fused_field_mlp
from customnerf_torch.ops.grid import GridSpec, grid_encode
from customnerf_torch.ops.triplane import (TriplaneSpec, triplane_encode,
                                           triplane_init)
from customnerf_torch.utils import threefry

# the reference field's encoder (network_grid.py:89-96)
PARITY_GRID = GridSpec(input_dim=3, num_levels=16, level_dim=2,
                       base_resolution=16, log2_hashmap_size=21,
                       desired_resolution=8192, gridtype="tiled")


def _sigmoid(x, dtype):
    """flax's sigmoid in the compute dtype, then f32."""
    return (sigmoid_bf16(x) if dtype == torch.bfloat16 else torch.sigmoid(x)).float()


def encode_positions(x01, table, spec):
    """The position encoder the spec's type selects: the tri-plane
    (``TriplaneSpec``) or the hash / tiled grid (``GridSpec``)."""
    if isinstance(spec, TriplaneSpec):
        return triplane_encode(x01, table, spec)
    return grid_encode(x01, table, spec)


def encoder_init(spec: GridSpec, key) -> torch.Tensor:
    """The grid table as the JAX package's ``encoder_init`` draws it from
    ``key``: U(−1e-4, 1e-4) over [table_size, level_dim]."""
    return torch.from_numpy(threefry.uniform(key, (spec.table_size, spec.level_dim),
                                             -1e-4, 1e-4))


@dataclass(frozen=True)
class FieldConfig:
    bound: float = 2.0
    grid: GridSpec | TriplaneSpec = PARITY_GRID
    dir_multires: int = 4
    hidden: int = 64
    train_conf: bool = True
    conf_channels: int = 1            # 2 when keyword2 is set
    detach_mask_from_field: bool = False
    mask_no_dir: bool = False
    mask_no_dir_nodetach: bool = False
    use_bias: bool = False
    compute_dtype: str = "float32"    # "bfloat16" under the fp16 flag
    backend: str = "xla"              # "pallas": the f32 fused head

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|bfloat16, "
                             f"got {self.compute_dtype}")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be xla|pallas, got {self.backend}")

    @property
    def dir_dim(self) -> int:
        return freq_encode_dim(self.dir_multires)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


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

    def names(self):
        return [f"hidden_{i}" for i in range(self.n_hidden)] + ["out"]

    def layers(self):
        return [getattr(self, n) for n in self.names()]

    def kernels(self):
        """[in, out] matrices in layer order (the flax Dense.kernel layout)."""
        return [l.weight.t().contiguous() for l in self.layers()]

    def forward(self, x, dtype=torch.float32):
        """The pre-activation output in ``dtype``: each layer takes its input
        and weights in ``dtype`` (flax's Dense under a compute dtype)."""
        *hidden, out = self.layers()
        x = x.to(dtype)

        def dense(layer, h):
            bias = None if layer.bias is None else layer.bias.to(dtype)
            return F.linear(h, layer.weight.to(dtype), bias)

        for layer in hidden:
            x = torch.relu(dense(layer, x))
        return dense(out, x)


class NeRFField(nn.Module):
    """Grid or tri-plane field: the default fused rgb + conf head, or a
    variant's plain heads (``fused`` tells which; ``fused_bf16`` whether the
    fused head runs the kernel's bf16 mode)."""

    def __init__(self, cfg: FieldConfig, seed: int = 0, device=None):
        super().__init__()
        if cfg.hidden != 64:
            raise ValueError("the fused head is 64 wide")
        self.cfg = cfg
        h, bias = cfg.hidden, cfg.use_bias
        split_conf = cfg.detach_mask_from_field or cfg.mask_no_dir
        self.fused = cfg.train_conf and not split_conf and not bias
        self.fused_bf16 = cfg.dtype == torch.bfloat16 and cfg.backend == "xla"
        table, kernel = self._draws(cfg.grid, int(seed))
        self.grid_table = nn.Parameter(table)
        self.feature_net = MLP(cfg.grid.output_dim, h, h, 2, bias)
        self.density_net = MLP(h, 1, h, 1, bias)
        rgb_out = 3 + (cfg.conf_channels if cfg.train_conf and not split_conf else 0)
        self.rgb_net = MLP(cfg.dir_dim + h, rgb_out, h, 1, bias)
        self.conf_net = None
        if cfg.train_conf and split_conf:
            conf_in = h if cfg.mask_no_dir else cfg.dir_dim + h
            self.conf_net = MLP(conf_in, cfg.conf_channels, h, 1, bias)
        self._init_mlps(kernel)
        self.to(device)

    def _mlps(self):
        return {name: m for name, m in (
            ("feature_net", self.feature_net), ("density_net", self.density_net),
            ("rgb_net", self.rgb_net), ("conf_net", self.conf_net)) if m is not None}

    @staticmethod
    def _draws(spec, seed: int):
        """(table, kernel) for a seed, drawn on the host and moved with the
        module, so a seed gives the same field on every device.
        ``kernel(module, layer, fan_in, fan_out)`` → the layer's [out, in]
        weight.  Both draw the heads from flax's Dense default, LeCun
        normal: a normal truncated to ±2σ with variance 1/fan_in.  (A
        normal clipped at ±2σ instead has 24 % more variance, and trained
        the bear fixture measurably worse, PERF.md.)

        The grid field draws as the JAX package's ``init_params(PRNGKey(
        seed))`` does (``utils/threefry.py``): the parity recipe's outcome
        depends on the initial draw, and its gate's anchor was trained from
        that draw.  The tri-plane field draws its table, then each head in
        order, from one seeded ``torch.Generator`` by inverting the
        truncated normal's CDF: the draw its quality gates were set on
        (PERF.md)."""
        if isinstance(spec, GridSpec):
            root = threefry.prng_key(seed)

            def kernel(module, layer, fan_in, fan_out):
                return threefry.lecun_normal(threefry.param_key(root, module, layer, 1),
                                             fan_in, (fan_in, fan_out)).t()
            return encoder_init(spec, threefry.param_key(root, 1)), kernel

        gen = torch.Generator().manual_seed(seed)
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))

        def kernel(module, layer, fan_in, fan_out):
            u = lo + (1.0 - 2.0 * lo) * torch.rand((fan_out, fan_in), generator=gen,
                                                   dtype=torch.float64)
            w = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
            return torch.clamp(w, -2.0, 2.0) * (fan_in ** -0.5 / 0.87962566103423978)
        return triplane_init(spec, generator=gen), kernel

    @torch.no_grad()
    def _init_mlps(self, kernel):
        # biases start at zero, as flax's do
        for name, mod in self._mlps().items():
            for layer, lin in zip(mod.names(), mod.layers()):
                lin.weight.copy_(kernel(name, layer, *lin.weight.shape[::-1]))
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
        return xf, encode_positions(x01, self.grid_table, c.grid).contiguous()

    def _plain_heads(self, x_en, view_en):
        """The variants' heads (``field.py:167-185``) in ``compute_dtype`` →
        (sigma_raw [N], radiance [N, R] after its sigmoids), both f32."""
        c, dt = self.cfg, self.cfg.dtype
        fea = self.feature_net(x_en, dt)
        sigma_raw = self.density_net(fea, dt)[..., 0].float()
        rgb_in = torch.cat([view_en.to(dt), fea], dim=-1)
        radiance = _sigmoid(self.rgb_net(rgb_in, dt), dt)
        if self.conf_net is not None:
            if c.mask_no_dir:
                conf_in = fea if c.mask_no_dir_nodetach else fea.detach()
            else:
                conf_in = rgb_in.detach()
            radiance = torch.cat([radiance, _sigmoid(self.conf_net(conf_in, dt), dt)], -1)
        return sigma_raw, radiance

    def forward(self, x, d):
        """x, d: [..., 3] positions / view directions → (sigma [...],
        radiance [..., 3 (+ conf_channels when train_conf)])."""
        prefix = x.shape[:-1]
        xf, x_en = self._encode(x)
        view_en = freq_encode(d.reshape(-1, 3), self.cfg.dir_multires)
        if self.fused:
            sigma_raw, rgb_raw = fused_field_mlp(x_en, view_en.contiguous(),
                                                 self.weights(), bf16=self.fused_bf16)
            radiance = _sigmoid(rgb_raw, torch.bfloat16 if self.fused_bf16
                                else torch.float32)
        else:
            sigma_raw, radiance = self._plain_heads(x_en, view_en)
        sigma = trunc_exp(sigma_raw + self.gaussian_blob(xf))
        return sigma.reshape(prefix), radiance.reshape(*prefix, radiance.shape[-1])

    def density(self, x):
        """x: [..., 3] world coords → sigma [...].  The default head runs the
        fused kernel without its rgb part, in the mode of ``forward``: the
        same sigma as ``make_pallas_apply``'s density (the full head on zero
        directions), or as the flax bf16 heads'."""
        xf, x_en = self._encode(x)
        if self.fused:
            sigma_raw, _ = fused_field_mlp(x_en, None, self.weights(), with_rgb=False,
                                           bf16=self.fused_bf16)
        else:
            dt = self.cfg.dtype
            sigma_raw = self.density_net(self.feature_net(x_en, dt), dt)[..., 0].float()
        return trunc_exp(sigma_raw + self.gaussian_blob(xf)).reshape(x.shape[:-1])


def param_groups(field: NeRFField):
    """('grid', [grid_table]) and ('mlp', [the rest]) — the encoder trains
    at lr×10 (reference network_grid.py:196-206)."""
    grid = [field.grid_table]
    mlp = [p for n, p in field.named_parameters() if n != "grid_table"]
    return {"grid": grid, "mlp": mlp}


def param_names(field: NeRFField):
    """The parameters' names in :func:`param_groups`' order (the index a
    ``torch.optim`` state dict gives each)."""
    return ["grid_table"] + [n for n, _ in field.named_parameters() if n != "grid_table"]
