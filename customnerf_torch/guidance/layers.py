"""Layers the SD UNet and VAE share (diffusers state-dict names), and the
seeded random initialisation of a whole guidance model.

The UNet and VAE follow flax's compute-dtype policy, the JAX package's
(``customnerf_tpu/guidance/unet.py``, ``vae.py``): a model casts its input
to its compute dtype once at entry, and then every layer computes in the
dtype of what it is given.  :class:`Linear` and :class:`Conv2d` cast their
weights to it at use (bf16 operands, f32 sums, a bf16 output: flax's Dense
and Conv with ``dtype=bfloat16``), or compute in f32 whatever they are
given with ``f32=True`` (the JAX package's ``dtype=jnp.float32`` convs on
the latent side); :class:`GroupNorm` and :class:`LayerNorm` compute their
statistics and the normalisation in f32 and give their input's dtype back
(flax's normalisers with bf16 params).  Explicit casts, not
``torch.autocast``: autocast's op lists are not flax's policy.  In f32 all
of these are plain ``torch.nn`` layers.

:class:`GroupNorm` takes ``silu=True`` to give the SiLU of its output (the
resnet blocks' and ``conv_norm_out``'s norm → SiLU).  On the card a bf16
input whose norm's weight and bias are bf16 and need no gradient takes one
hand-written kernel pair, forward and backward (:func:`group_norm_kernel`,
``csrc/group_norm.cu``, on the input made contiguous NCHW), which rounds
where the plain chain (:func:`group_norm`) rounds; what the kernel does not
take there raises.  The chain is kept, on the card, for the inputs whose
function differs (f32, or a weight or bias that trains), each adding one to
the tracer's ``group_norm_plain`` counter; CPU inputs take the chain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.engine import spans
from customnerf_torch.ops import kernels

KERNEL_BLOCKS = 2048           # blocks a group-norm launch aims at: ~2 waves on 132 SMs
KERNEL_MIN_CHUNK = 4096        # elements a block takes at least: 2 loads of 16 bytes a thread
KERNEL_MAX_GROUP_CHANNELS = 1024   # csrc/group_norm.cu's shared memory
KERNEL_MAX_ROWS = 65535        # N·groups: the launch grid's y extent
KERNEL_MAX_SPAN = 2 ** 31 - 1  # (C/groups)·H·W: int32 offsets in a row


def _like(t, x):
    return None if t is None else t.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, the weights cast at use."""

    def forward(self, x):
        return F.linear(x, _like(self.weight, x), _like(self.bias, x))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, the weights cast at use; in f32
    whatever its input with ``f32=True``."""

    def __init__(self, *args, f32: bool = False, **kw):
        super().__init__(*args, **kw)
        self.f32 = f32

    def forward(self, x):
        if self.f32:
            x = x.float()
        return self._conv_forward(x, _like(self.weight, x), _like(self.bias, x))


def group_norm(x, groups: int, weight, bias, eps: float, silu: bool = False):
    """The plain chain: statistics and normalisation in f32, the input's
    dtype out, and with ``silu`` the SiLU of that in the input's dtype (the
    CPU path, the f32 path and the kernel's oracle)."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps).to(x.dtype)
    return F.silu(y) if silu else y


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def takes_kernel(x, weight, bias) -> bool:
    """Whether a card input goes to the kernel: x, weight and bias bf16, and
    a weight and bias that need no gradient (frozen, or grad mode off).  Any
    layout: the route hands the kernel x in contiguous NCHW."""
    return (x.dtype == torch.bfloat16
            and all(t is not None and t.dtype == x.dtype for t in (weight, bias))
            and not (torch.is_grad_enabled()
                     and (weight.requires_grad or bias.requires_grad)))


def kernel_split(rows: int, span: int) -> tuple:
    """(chunk, splits): each of the ``rows`` (n, g) spans of ``span``
    elements is cut into ``splits`` chunks of ``chunk`` elements (a
    multiple of 8, the last one shorter), one block each, so that a launch
    has about KERNEL_BLOCKS blocks and a block at least KERNEL_MIN_CHUNK
    elements: a 4 M-element VAE span splits 64 ways, a 2,560-element UNet
    span at 8² not at all."""
    want = max(1, min(-(-KERNEL_BLOCKS // rows), span // KERNEL_MIN_CHUNK))
    chunk = -(-span // want)
    chunk = -(-chunk // 8) * 8
    return chunk, -(-span // chunk)


def check_kernel(x, weight, bias, groups: int) -> None:
    """Raise on what the kernel does not take: x [N, C, H, W] bf16,
    contiguous, C split into ``groups`` of at most KERNEL_MAX_GROUP_CHANNELS
    channels, N·groups ≤ KERNEL_MAX_ROWS, a group's span below 2^31; weight
    and bias [C] bf16, contiguous, on x's device."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm: the kernel takes bfloat16, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"group_norm: the kernel takes contiguous [N, C, H, W], not "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    n, c, h, w = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"group_norm: {c} channels do not split into {groups} groups")
    if c // groups > KERNEL_MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm: the kernel takes at most "
                         f"{KERNEL_MAX_GROUP_CHANNELS} channels a group, not {c // groups}")
    if n * groups > KERNEL_MAX_ROWS:
        raise ValueError(f"group_norm: the kernel takes N × groups ≤ {KERNEL_MAX_ROWS}, "
                         f"not {n * groups}")
    if c // groups * h * w > KERNEL_MAX_SPAN:
        raise ValueError(f"group_norm: a group's {c // groups * h * w} elements exceed "
                         f"{KERNEL_MAX_SPAN}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or t.shape != (c,) or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm: the kernel takes a contiguous [{c}] {name} "
                             f"on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"group_norm: the kernel takes a {x.dtype} {name}, not {t.dtype}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _geometry(x, groups: int):
    """(rows, cpg, hw, chunk, splits) of a launch, and its partials' scratch."""
    n, c, h, w = x.shape
    rows, cpg = n * groups, c // groups
    chunk, splits = kernel_split(rows, cpg * h * w)
    partials = torch.empty(rows * splits * 2, dtype=torch.float32, device=x.device)
    return (rows, cpg, h * w, chunk, splits), partials


def _kernel_forward(x, weight, bias, groups: int, eps: float, silu: bool):
    """(y, mean, rstd) from ``csrc/group_norm.cu``'s forward."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = torch.empty(x.shape[0] * groups, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel():
        (rows, cpg, hw, chunk, splits), partials = _geometry(x, groups)
        with torch.cuda.device(x.device):
            err = kernels.library().cn_group_norm_forward(
                x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                partials.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, groups, cpg,
                hw, chunk, splits, float(eps), int(silu), _stream())
        kernels.check(err, "group_norm")
    return y, mean, rstd


def _kernel_backward(x, dy, weight, bias, mean, rstd, groups: int, silu: bool):
    """dx from ``csrc/group_norm.cu``'s backward (γ and β get none)."""
    dy = dy.to(x.dtype).contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        (rows, cpg, hw, chunk, splits), partials = _geometry(x, groups)
        with torch.cuda.device(x.device):
            err = kernels.library().cn_group_norm_backward(
                x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), partials.data_ptr(), rows,
                groups, cpg, hw, chunk, splits, int(silu), _stream())
        kernels.check(err, "group_norm backward")
    return dx


class _GroupNormKernel(torch.autograd.Function):
    """The kernel pair under autograd: saves the bf16 input, mean and rstd
    (no f32 copy) and gives the input's gradient alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        y, mean, rstd = _kernel_forward(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx = _kernel_backward(x, dy, weight, bias, mean, rstd, ctx.groups, ctx.silu)
        return dx, None, None, None, None, None


def group_norm_kernel(x, weight, bias, groups: int, eps: float, silu: bool = False):
    """:func:`group_norm` by the kernels (``csrc/group_norm.cu``) on a CUDA
    bf16 input; differentiable in x (the backward is a kernel pair too).
    The kernels count their launches, graph replays included:
    ``kernels.device_launches("group_norm")``."""
    check_kernel(x, weight, bias, groups)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GroupNormKernel.apply(x, weight, bias, groups, eps, silu)
    return _kernel_forward(x, weight, bias, groups, eps, silu)[0]


class GroupNorm(nn.GroupNorm):
    """Statistics and normalisation in f32, the input's dtype out; with
    ``silu`` the SiLU of that.  On the card a bf16 input whose bf16 weight
    and bias need no gradient (:func:`takes_kernel`) takes the kernels, in
    any layout (a contiguous NCHW copy of it where it is not so); any other
    card input takes :func:`group_norm` and adds one to the tracer's
    ``group_norm_plain`` counter; a CPU input takes :func:`group_norm`."""

    def forward(self, x, silu: bool = False):
        if _on_card(x):
            if takes_kernel(x, self.weight, self.bias):
                return group_norm_kernel(x.contiguous(), self.weight, self.bias,
                                         self.num_groups, self.eps, silu)
            spans.count("group_norm_plain")
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, silu)


class LayerNorm(nn.LayerNorm):
    """Statistics and normalisation in f32, the input's dtype out."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int],
                 groups: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3×3 conv; the VAE encoder pads (0, 1, 0, 1) first."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(channels, channels, 3, stride=2,
                           padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def build(cls, *args, device=None, generator=None, dtype=None, **kw):
    """Construct ``cls(*args, **kw)`` without PyTorch's default init, on
    ``device`` (``"meta"`` gives shapes only), its parameters stored in
    ``dtype`` (default f32), then, unless on ``meta``, initialise it from
    ``generator`` with :func:`init_random_`."""
    with torch.device("meta"):
        module = cls(*args, **kw)
    if dtype is not None:
        module = module.to(dtype)
    device = torch.device(device or "cpu")
    if device.type == "meta":
        return module
    module = module.to_empty(device=device)
    init_random_(module, generator)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator=None):
    """The flax defaults, drawn in parameter order from one generator:
    LeCun-normal kernels (std = fan_in^-½), zero biases, unit norm scales
    (those of a module with ``unit_init`` too: the RMS norms), N(0, 0.02)
    embeddings and CLIP class embeddings.  A parameter stored below f32
    takes the f32 draw rounded, one tensor at a time: the same values as
    an f32 module's, with no f32 copy of the whole."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif getattr(owner, "unit_init", False):
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif p.ndim == 0:
            p.fill_(2.6592)     # CLIP logit_scale_init_value
        else:
            std = 0.02 if isinstance(owner, nn.Embedding) or p.ndim == 1 else p[0].numel() ** -0.5
            draw = p if p.dtype == torch.float32 else torch.empty(p.shape, device=p.device)
            draw.normal_(0.0, std, generator=generator)
            if draw is not p:
                p.copy_(draw)
    return module


def compute_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` name ("float32" | "bfloat16") as a torch dtype."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {name}")
    return getattr(torch, name)


def n_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
