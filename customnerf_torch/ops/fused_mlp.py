"""Fused field-MLP forward: hand-written CUDA kernel + its plain version
(counterpart of ``customnerf_tpu/ops/fused_mlp_pallas.py``).

``fused_field_mlp`` is a ``torch.autograd.Function``: the forward runs the
kernel (``csrc/fused_mlp.cu``) on a CUDA tensor and :func:`reference_forward`
on a CPU tensor; the backward is autograd of :func:`reference_forward` with
plain ``torch.matmul``s, exactly as the JAX backward is autodiff of
``_reference_forward`` (``fused_mlp_pallas.py:155-160``).

Weights are the seven head matrices in ``[in, out]`` layout (flax
``Dense.kernel``): w1 [in, 64], w2, w3, wd1 [64, 64], wd2 [64, 1],
wr1 [dir + 64, 64], wr2 [64, n_out].

Two modes, chosen by an argument: f32 (split-TF32, the JAX Pallas kernel's
f32 contract, ``--backend pallas``) and ``bf16``, the flax bf16 head the
JAX package runs under ``-O``/``-O2`` with ``--backend xla``
(``models/field.py:84-106``): inputs and weights rounded to bf16, f32 sums,
every layer's output rounded to bf16, ReLU on the rounded value; sigma_raw
and rgb_raw are bf16 values widened to f32.  Inputs and weights are f32 in
both modes (the f32 master weights); the bf16 backward is autograd of the
plain bf16 head, whose casts carry the cotangent back to f32 as JAX's do.
The backward is the tracer's device span ``k1.bwd`` (``engine/spans.py``).
"""

from __future__ import annotations

import torch

from customnerf_torch.engine import spans
from customnerf_torch.ops import kernels

HIDDEN = 64
MAX_DIR = 32        # the kernel holds view_en as at most four k8 blocks


def reference_forward(x_en, view_en, weights, with_rgb: bool = True,
                      dtype=torch.float32):
    """Plain PyTorch version of the kernel: (sigma_raw [B], rgb_raw
    [B, n_out]) in f32, or (sigma_raw, None) without the rgb head.  With
    ``dtype=torch.bfloat16``, the flax bf16 head: every matmul takes bf16
    operands and gives a bf16 output (f32 sums)."""
    w1, w2, w3, wd1, wd2, wr1, wr2 = (w.to(dtype) for w in weights)
    h = torch.relu(x_en.to(dtype) @ w1)
    h = torch.relu(h @ w2)
    fea = h @ w3
    sigma_raw = (torch.relu(fea @ wd1) @ wd2)[..., 0].float()
    if not with_rgb:
        return sigma_raw, None
    rgb_in = torch.cat([view_en.to(dtype), fea], dim=-1)
    rgb_raw = torch.relu(rgb_in @ wr1) @ wr2
    return sigma_raw, rgb_raw.float()


def _check(x_en, view_en, weights, with_rgb):
    B, in_dim = x_en.shape
    n_out = weights[6].shape[1]
    dir_dim = weights[5].shape[0] - HIDDEN
    shapes = [(in_dim, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN),
              (HIDDEN, HIDDEN), (HIDDEN, 1), (dir_dim + HIDDEN, HIDDEN),
              (HIDDEN, n_out)]
    tensors = (x_en, *weights) + ((view_en,) if with_rgb else ())
    for t in tensors:
        if t.device != x_en.device:
            raise ValueError("fused_mlp_forward: all tensors must share a device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp_forward: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_mlp_forward: tensors must be contiguous")
    if with_rgb and tuple(view_en.shape) != (B, dir_dim):
        raise ValueError(f"fused_mlp_forward: view_en shape {tuple(view_en.shape)}"
                         f" != {(B, dir_dim)}")
    for w, shape in zip(weights, shapes):
        if tuple(w.shape) != shape:
            raise ValueError(f"fused_mlp_forward: weight shape {tuple(w.shape)} "
                             f"!= {shape}")
    if not 1 <= n_out <= 8:
        raise ValueError(f"fused_mlp_forward: n_out={n_out} not in [1, 8]")


def _check_kernel(x_en, view_en, with_rgb):
    """What the kernel needs beyond the function's contract."""
    in_dim = x_en.shape[1]
    # it copies x_en and view_en rows in 16-byte chunks
    if in_dim % 4 or x_en.data_ptr() % 16:
        raise ValueError(f"fused_mlp_forward: the kernel needs in_dim % 4 == 0 "
                         f"and a 16-byte aligned x_en (in_dim={in_dim})")
    if with_rgb and (view_en.shape[1] > MAX_DIR or view_en.data_ptr() % 16):
        raise ValueError(f"fused_mlp_forward: the kernel needs dir_dim <= "
                         f"{MAX_DIR} and a 16-byte aligned view_en")


def fused_mlp_forward(x_en, view_en, weights, with_rgb: bool = True,
                      bf16: bool = False):
    """Forward only.  x_en [B, in] f32, view_en [B, dir] f32, contiguous
    (``view_en`` is not read, and may be None, when ``with_rgb`` is False:
    rgb_raw is then None); ``bf16`` picks the bf16 mode.  CUDA tensors
    launch the kernel (it counts its launches on the card, a graph's replays
    included: ``kernels.device_launches``); CPU tensors take the plain
    version."""
    weights = tuple(weights)
    _check(x_en, view_en, weights, with_rgb)
    if x_en.device.type == "cpu":
        return reference_forward(x_en, view_en, weights, with_rgb,
                                 torch.bfloat16 if bf16 else torch.float32)
    if x_en.device.type != "cuda":
        raise ValueError(f"fused_mlp_forward: unsupported device {x_en.device}")
    _check_kernel(x_en, view_en, with_rgb)
    B, in_dim = x_en.shape
    n_out = weights[6].shape[1]
    sigma = torch.empty(B, device=x_en.device, dtype=torch.float32)
    rgb = (torch.empty(B, n_out, device=x_en.device, dtype=torch.float32)
           if with_rgb else None)
    dir_dim = weights[5].shape[0] - HIDDEN
    lib = kernels.library()
    # the kernel packs the weights here once a call, in the order its
    # blocks copy them into shared memory
    if bf16:
        n_packed = lib.cn_fused_mlp_bf16_packed_elems(in_dim, dir_dim, n_out,
                                                      int(with_rgb))
        launch, packed_dtype = lib.cn_fused_mlp_bf16_forward, torch.bfloat16
    else:
        n_packed = lib.cn_fused_mlp_packed_floats(in_dim, dir_dim, n_out,
                                                  int(with_rgb))
        launch, packed_dtype = lib.cn_fused_mlp_forward, torch.float32
    packed = torch.empty(n_packed, device=x_en.device, dtype=packed_dtype)
    with torch.cuda.device(x_en.device):
        err = launch(
            x_en.data_ptr(), view_en.data_ptr() if with_rgb else None,
            *[w.data_ptr() for w in weights], packed.data_ptr(),
            sigma.data_ptr(), rgb.data_ptr() if with_rgb else None,
            B, in_dim, dir_dim, n_out, int(with_rgb),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "fused_mlp_forward")
    return sigma, rgb


class _FusedFieldMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_en, view_en, with_rgb, bf16, *weights):
        ctx.with_rgb, ctx.bf16 = with_rgb, bf16
        ctx.save_for_backward(x_en, view_en, *weights)
        sigma, rgb = fused_mlp_forward(x_en, view_en, weights, with_rgb, bf16)
        return (sigma, rgb) if with_rgb else sigma

    @staticmethod
    def backward(ctx, *grads):
        with spans.device("k1.bwd"):
            return _FusedFieldMLP._backward(ctx, *grads)

    @staticmethod
    def _backward(ctx, *grads):
        x_en, view_en, *weights = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 *ctx.needs_input_grad[4:])
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip((x_en, view_en, *weights), needs)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        if not wanted:
            return (None,) * (len(inputs) + 2)
        with torch.enable_grad():
            outs = reference_forward(inputs[0], inputs[1], inputs[2:],
                                     ctx.with_rgb,
                                     torch.bfloat16 if ctx.bf16 else torch.float32)
            # an output that depends on none of the wanted inputs (sigma when
            # only the rgb head's weights train) has no graph: leave it out
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if o is not None and o.requires_grad and g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], wanted,
                                      [g for _, g in pairs], allow_unused=True)
        it = iter(got)
        out = [next(it) if t is not None and t.requires_grad else None
               for t in inputs]
        return (out[0], out[1], None, None, *out[2:])


def fused_field_mlp(x_en, view_en, weights, with_rgb: bool = True,
                    bf16: bool = False):
    """sigma_raw [B], rgb_raw [B, n_out] (None without the rgb head):
    kernel forward, autograd-of-the-plain-version backward; ``bf16`` picks
    the flax bf16 head."""
    out = _FusedFieldMLP.apply(x_en, view_en, with_rgb, bf16, *weights)
    return out if with_rgb else (out, None)
