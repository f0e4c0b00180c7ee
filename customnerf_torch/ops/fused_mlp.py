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
"""

from __future__ import annotations

import torch

from customnerf_torch.ops import kernels

HIDDEN = 64


def reference_forward(x_en, view_en, weights):
    """Plain PyTorch version of the kernel: (sigma_raw [B], rgb_raw [B, n_out])."""
    w1, w2, w3, wd1, wd2, wr1, wr2 = weights
    h = torch.relu(x_en @ w1)
    h = torch.relu(h @ w2)
    fea = h @ w3
    sigma_raw = (torch.relu(fea @ wd1) @ wd2)[..., 0]
    rgb_in = torch.cat([view_en, fea], dim=-1)
    rgb_raw = torch.relu(rgb_in @ wr1) @ wr2
    return sigma_raw, rgb_raw


def _check(x_en, view_en, weights):
    B, in_dim = x_en.shape
    dir_dim = view_en.shape[1]
    n_out = weights[6].shape[1]
    shapes = [(in_dim, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN),
              (HIDDEN, HIDDEN), (HIDDEN, 1), (dir_dim + HIDDEN, HIDDEN),
              (HIDDEN, n_out)]
    for t in (x_en, view_en, *weights):
        if t.device != x_en.device:
            raise ValueError("fused_mlp_forward: all tensors must share a device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp_forward: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_mlp_forward: tensors must be contiguous")
    for w in weights:
        # the kernel stages weights with 16-byte loads
        if w.data_ptr() % 16:
            raise ValueError("fused_mlp_forward: weights must be 16-byte aligned")
    if view_en.shape[0] != B:
        raise ValueError("fused_mlp_forward: x_en and view_en batch differ")
    for w, shape in zip(weights, shapes):
        if tuple(w.shape) != shape:
            raise ValueError(f"fused_mlp_forward: weight shape {tuple(w.shape)} "
                             f"!= {shape}")
    if not 1 <= n_out <= 8:
        raise ValueError(f"fused_mlp_forward: n_out={n_out} not in [1, 8]")


def fused_mlp_forward(x_en, view_en, weights):
    """Forward only.  x_en [B, in] f32, view_en [B, dir] f32, contiguous.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    weights = tuple(weights)
    _check(x_en, view_en, weights)
    if x_en.device.type == "cpu":
        return reference_forward(x_en, view_en, weights)
    if x_en.device.type != "cuda":
        raise ValueError(f"fused_mlp_forward: unsupported device {x_en.device}")
    B, in_dim = x_en.shape
    n_out = weights[6].shape[1]
    sigma = torch.empty(B, device=x_en.device, dtype=torch.float32)
    rgb = torch.empty(B, n_out, device=x_en.device, dtype=torch.float32)
    lib = kernels.library()
    with torch.cuda.device(x_en.device):
        err = lib.cn_fused_mlp_forward(
            x_en.data_ptr(), view_en.data_ptr(),
            *[w.data_ptr() for w in weights],
            sigma.data_ptr(), rgb.data_ptr(),
            B, in_dim, view_en.shape[1], n_out,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "fused_mlp_forward")
    fused_mlp_forward.launches += 1
    return sigma, rgb


fused_mlp_forward.launches = 0


class _FusedFieldMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_en, view_en, *weights):
        ctx.save_for_backward(x_en, view_en, *weights)
        return fused_mlp_forward(x_en, view_en, weights)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        x_en, view_en, *weights = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip((x_en, view_en, *weights), ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * len(inputs)
        with torch.enable_grad():
            outs = reference_forward(inputs[0], inputs[1], inputs[2:])
            # an output that depends on none of the wanted inputs (sigma when
            # only the rgb head's weights train) has no graph: leave it out
            pairs = [(o, g) for o, g in zip(outs, (g_sigma, g_rgb))
                     if o.requires_grad]
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        wanted, [g for _, g in pairs],
                                        allow_unused=True)
        it = iter(grads)
        return tuple(next(it) if t.requires_grad else None for t in inputs)


def fused_field_mlp(x_en, view_en, weights):
    """sigma_raw [B], rgb_raw [B, n_out]: kernel forward, autograd-of-the-
    plain-version backward."""
    return _FusedFieldMLP.apply(x_en, view_en, *weights)
