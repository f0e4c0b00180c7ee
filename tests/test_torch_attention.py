"""The UNet's attention on the CPU: which route ``guidance/unet.py::attend``
gives each input, what ``check_kernel`` refuses, and a plain-torch, block-wise
emulation of the card kernel's two passes (``csrc/attention.cu``) against the
plain :func:`attention`.

The emulation computes what the kernel computes, in the kernel's order:
64-key tiles, pass 1 keeping each row's running max and rescaled sum, pass 2
forming exp(s − max) / sum, rounding it to bf16 and accumulating P·V in f32,
the output rounded once.  It must match the plain function, which rounds the
probabilities after the softmax, while the flash-style order (round exp(s −
max), divide the output by the sum at the end) must not: the test pins the
point where the kernel rounds.  Tolerance: both sides round the same f32
values; the sums differ in order only (the online sum's rescaling, each
tile's products), so a probability near a bf16 rounding boundary can land one
ulp apart (at most 2^-8 for p ≤ 1) and move an output by at most 2^-8 of the
largest |v|, and the output's own rounding then by one ulp (2^-7 of it); on
N(0, 1) inputs fewer than 1 in 1,000 outputs differ at all.  The
flash-style order moves about a quarter of them.
"""

import math

import pytest
import torch

from customnerf_torch.engine import spans
from customnerf_torch.guidance import unet
from customnerf_torch.guidance.unet import attention

KEYS = 64                   # keys a tile of the kernel


def _heads(t, heads):
    b, n, inner = t.shape
    return t.view(b, n, heads, inner // heads).transpose(1, 2).float()


def two_pass(q, k, v, heads, normalise_first=True):
    """The kernel's algorithm in plain torch (f32 on bf16 inputs); with
    ``normalise_first`` False, the flash-style rounding point instead."""
    d, m = q.shape[2] // heads, k.shape[1]
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    scale = 1.0 / math.sqrt(d)
    tiles = [slice(j, min(j + KEYS, m)) for j in range(0, m, KEYS)]
    mx = torch.full(qh.shape[:-1] + (1,), -math.inf)
    total = torch.zeros_like(mx)
    for sl in tiles:                                    # pass 1
        s = torch.matmul(qh, kh[:, :, sl].transpose(-1, -2)) * scale
        new = torch.maximum(mx, s.amax(-1, keepdim=True))
        total = total * torch.exp(mx - new) + torch.exp(s - new).sum(-1, keepdim=True)
        mx = new
    o = torch.zeros(qh.shape[:-1] + (vh.shape[-1],))
    for sl in tiles:                                    # pass 2
        e = torch.exp(torch.matmul(qh, kh[:, :, sl].transpose(-1, -2)) * scale - mx)
        p = e / total if normalise_first else e
        o += torch.matmul(p.to(torch.bfloat16).float(), vh[:, :, sl])
    if not normalise_first:
        o = o / total
    b, h, n, d = o.shape
    return o.to(torch.bfloat16).transpose(1, 2).reshape(b, n, h * d)


def _qkv(b, n, m, heads, d, sharp=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k = (sharp * torch.randn(b, r, heads * d, generator=g) for r in (n, m))
    v = torch.randn(b, m, heads * d, generator=g)
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.parametrize("d,heads,n,m,sharp", [
    (40, 8, 256, 77, 1.0),        # SD 1.5 level 0's heads, cross-attention
    (64, 10, 200, 77, 1.0),       # SDXL's heads, cross-attention, ragged n
    (40, 8, 256, 77, 3.0),        # peaked rows
    (64, 4, 300, 300, 3.0),       # self-attention with a masked last key tile
])
def test_two_pass_emulation_rounds_where_attention_rounds(d, heads, n, m, sharp):
    q, k, v = _qkv(2, n, m, heads, d, sharp)
    want = attention(q, k, v, heads).float()
    got = two_pass(q, k, v, heads).float()
    diff = (got - want).abs()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool((diff <= 2.0 ** -7 * want.abs() + 2.0 ** -8 * v.float().abs().max()).all())
    assert float((diff > 0).float().mean()) < 1e-3
    flash = (two_pass(q, k, v, heads, normalise_first=False).float() - want).abs()
    assert float((flash > 0).float().mean()) > 0.1


@pytest.mark.parametrize("dtype,requires_grad,grad_mode,kernel", [
    (torch.bfloat16, False, True, True),      # the editing UNet (SDS: no_grad)
    (torch.bfloat16, True, False, True),      # adapters under no_grad
    (torch.bfloat16, True, True, False),      # Custom Diffusion tuning
    (torch.float32, False, False, False),     # the f32 UNet
    (torch.float32, True, True, False),
])
def test_takes_kernel_on_dtype_and_grad(dtype, requires_grad, grad_mode, kernel):
    q, k, v = (t.to(dtype) for t in _qkv(1, 8, 8, 2, 8))
    k.requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_mode):
        assert unet.takes_kernel(q, k, v) is kernel
    assert unet.takes_kernel(q.bfloat16(), k.bfloat16().detach(), v.float()) is False


def test_attend_routes_each_input(monkeypatch):
    """On the card (faked) the kernel for bf16 no-grad inputs, the plain
    function and one ``attention_plain`` count for the others; on the CPU
    the plain function and no count."""
    q, k, v = _qkv(2, 16, 77, 2, 8)
    calls = []
    plain = attention(q, k, v, 2)
    count = spans.counters["attention_plain"]
    assert torch.equal(unet.attend(q, k, v, 2), plain)
    assert spans.counters["attention_plain"] == count

    monkeypatch.setattr(unet, "_on_card", lambda t: True)
    monkeypatch.setattr(unet, "attention_kernel",
                        lambda *a: calls.append(a) or torch.zeros_like(a[0]))
    with torch.no_grad():
        assert not unet.attend(q, k, v, 2).any()
    assert len(calls) == 1 and spans.counters["attention_plain"] == count
    f32 = unet.attend(q.float(), k.float(), v.float(), 2)
    assert f32.dtype == torch.float32 and len(calls) == 1
    k.requires_grad_(True)
    out = unet.attend(q, k, v, 2)
    assert out.requires_grad and torch.equal(out.detach(), plain)
    assert len(calls) == 1 and spans.counters["attention_plain"] == count + 2


def _aligned_view(b, n, inner, offset):
    """A [b, n, inner] bf16 view whose base lies ``offset`` elements into a
    16-byte aligned buffer."""
    buf = torch.zeros(b * n * inner + 8, dtype=torch.bfloat16)
    return buf[offset:offset + b * n * inner].view(b, n, inner)


@pytest.mark.parametrize("bad,error", [
    ("head_12", ValueError), ("head_168", ValueError), ("float32", TypeError),
    ("column_stride", ValueError), ("base_8_bytes", ValueError), ("no_keys", ValueError),
    ("values_shape", ValueError), ("blocks", ValueError), ("heads_split", ValueError),
    ("row_stride", ValueError),
])
def test_check_kernel_refuses_what_the_kernel_does_not_take(bad, error):
    heads, d = 2, 16
    q, k, v = _qkv(2, 8, 5, heads, d)
    if bad == "head_12":
        q, k, v = _qkv(2, 8, 5, heads, 12)
    elif bad == "head_168":
        q, k, v = _qkv(1, 8, 5, heads, 168)
    elif bad == "float32":
        v = v.float()
    elif bad == "column_stride":
        q = torch.zeros(2, 8, 2 * heads * d, dtype=torch.bfloat16)[..., ::2]
    elif bad == "base_8_bytes":
        q = _aligned_view(2, 8, heads * d, 4)
    elif bad == "no_keys":
        k, v = k[:, :0], v[:, :0]
    elif bad == "values_shape":
        v = v[:, :4]
    elif bad == "blocks":
        q, k, v = _qkv(1, 1, 1, unet.KERNEL_MAX_BLOCKS + 1, 8)
        heads = unet.KERNEL_MAX_BLOCKS + 1
    elif bad == "heads_split":
        heads = 3
    elif bad == "row_stride":        # rows 2^24 elements apart (never touched)
        k = torch.empty(2, 1, unet.KERNEL_MAX_ROW_STRIDE, dtype=torch.bfloat16)
        k = k[:, :, :heads * d]
        v = k
    unet.check_kernel(*_qkv(2, 8, 5, 2, d), 2)             # the good case passes
    with pytest.raises(error):
        unet.check_kernel(q, k, v, heads)


@pytest.mark.parametrize("d", range(8, unet.KERNEL_MAX_HEAD + 1, 8))
def test_check_kernel_takes_every_head_width_it_names(d):
    unet.check_kernel(*_qkv(2, 3, 77, 2, d), 2)
    unet.check_kernel(*(t[:, 1:] for t in _qkv(2, 9, 78, 2, d)), 2)   # row-offset views
