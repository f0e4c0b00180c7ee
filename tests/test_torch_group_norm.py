"""The SD stack's GroupNorm on the CPU: which route
``guidance/layers.py::GroupNorm`` gives each input, what ``check_kernel``
refuses, the split the wrapper hands the kernel, the state dict's keys, and a
plain-torch emulation of the card kernels (``csrc/group_norm.cu``) against
the plain chain (:func:`group_norm`) and an f64 oracle.

The emulation computes what the kernels compute, in their order: each
(n, g) span cut into the wrapper's chunks (``kernel_split`` at the rows of
the real call, though fewer rows are emulated), 256 threads a chunk taking
vectors of 8 (1 where H·W is not a multiple of 8) four at a time (two of
x and two of the cotangent in the backward), each
thread folding the 32 values' own mean and squared deviations into its f32
(count, mean, M2) by Chan's formula, a shuffle-down tree over a warp's
lanes, the warps in order, and each row's partials merged lane-strided then
by the same tree; the output rounded to bf16 after a·x + b (one rounding:
the kernel's fused multiply-add, emulated in f64) and the SiLU of that
value rounded again.  The backward recomputes the cotangent the chain's
f32 GroupNorm backward sees (the bf16-rounded SiLU backward), sums
γ·g·x and γ·g per thread, tree and row the same way, and forms
dx = bf16(rstd·γ·g + c2·x + c3) with PyTorch's c2 and c3.

Tolerances, both sides in f32 on the same bf16 values: the statistics
differ from the f64 oracle by f32 rounding in sums of up to 4 M terms
(relative 1e-6 of the spread, measured ≤ 1.5e-7); an output then lands one
bf16 ulp (≤ 2^-7 of it) from the chain's where its f32 value sits that
close to a rounding boundary, which fewer than 1 in 1,000 outputs do; the
backward's c2·x + c3 cancels to a small dx where x is near the mean, so dx
may differ by one ulp of itself plus 2^-12 of the largest |dx|.
"""

import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import sd as ref_sd
from benchmark.reference import sdxl as ref_xl
from customnerf_torch.engine import spans
from customnerf_torch.guidance import layers, unet, vae
from customnerf_torch.guidance.layers import GroupNorm, build, group_norm

THREADS, WARPS, UNROLL, BWD_UNROLL = 256, 8, 4, 2


# ------------------------------------------------------------ emulation
def _fma(a, b, c):
    """fmaf: the product and sum once rounded (f64 holds the product)."""
    return (a.double() * b.double() + c.double()).float()


def _rnd(v):
    return v.to(torch.bfloat16).float()


def _chan(a, b):
    """Chan's merge of (count, mean, M2) states, as the kernel's ``chan``."""
    na, ma, qa = a
    nb, mb, qb = b
    n = na + nb
    wb = nb.float() / n.clamp(min=1).float()
    d = mb - ma
    m = _fma(d, wb, ma)
    q = qa + qb + d * d * (na.float() * wb)
    m = torch.where(nb == 0, ma, torch.where(na == 0, mb, m))
    q = torch.where(nb == 0, qa, torch.where(na == 0, qb, q))
    return n, m, q


def _tree(state, merge):
    """Lane 0 of a shuffle-down tree over the last axis (32 lanes)."""
    state = [t.clone() for t in state]
    for off in (16, 8, 4, 2, 1):
        low = [t[..., :off] for t in state]
        high = [t[..., off:2 * off] for t in state]
        for t, new in zip(state, merge(low, high)):
            t[..., :off] = new
    return [t[..., 0] for t in state]


def _sums(a, b):
    return [x + y for x, y in zip(a, b)]


def _thread_vectors(rows, chunk, vec, unroll=UNROLL):
    """rows [R, span] → (values [R, S, iters, unroll, THREADS, vec], valid
    [S, iters, unroll, THREADS], the element offset in the row of each
    vector [S, iters, unroll, THREADS]): the vectors each thread loads."""
    R, span = rows.shape
    S = -(-span // chunk)
    per = -(-(chunk // vec) // (unroll * THREADS)) * unroll * THREADS
    padded = torch.zeros(R, S, per * vec)
    flat = torch.zeros(R, S * chunk)
    flat[:, :span] = rows
    padded[:, :, :chunk] = flat.view(R, S, chunk)
    j = torch.arange(per)
    lens = torch.tensor([min(chunk, span - s * chunk) for s in range(S)])
    valid = j[None, :] < (lens // vec)[:, None]
    offset = torch.arange(S)[:, None] * chunk + j[None, :] * vec
    shape = (S, per // (unroll * THREADS), unroll, THREADS)
    return (padded.view(R, *shape, vec), valid.view(shape), offset.view(shape))


def emulate_stats(rows, chunk, vec, eps):
    """(mean, rstd) [R] of the kernel's split Welford / Chan merge."""
    R, span = rows.shape
    vals, valid, _ = _thread_vectors(rows, chunk, vec)
    S, iters = valid.shape[:2]
    st = (torch.zeros(R, S, THREADS, dtype=torch.int64), torch.zeros(R, S, THREADS),
          torch.zeros(R, S, THREADS))
    for it in range(iters):
        ok = valid[:, it]                                   # [S, UNROLL, THREADS]
        k = ok.sum(1)                                       # valid vectors a thread
        total = torch.zeros(R, S, THREADS)
        for u in range(UNROLL):
            for i in range(vec):
                total = torch.where(ok[:, u], total + vals[:, :, it, u, :, i], total)
        cnt = (k * vec).expand(R, S, THREADS)
        bm = torch.where(k == UNROLL, total * (1.0 / (UNROLL * vec)),
                         total / cnt.clamp(min=1).float())
        bq = torch.zeros(R, S, THREADS)
        for u in range(UNROLL):
            for i in range(vec):
                d = vals[:, :, it, u, :, i] - bm
                bq = torch.where(ok[:, u], _fma(d, d, bq), bq)
        st = _chan(st, (cnt, bm, bq))
    warps = _tree([t.view(R, S, WARPS, 32) for t in st], _chan)
    block = [t[..., 0] for t in warps]
    for w in range(1, WARPS):
        block = _chan(block, [t[..., w] for t in warps])
    _, pm, pq = block                                       # [R, S] partials
    counts = torch.tensor([min(chunk, span - s * chunk) for s in range(S)])
    lanes = (torch.zeros(R, 32, dtype=torch.int64), torch.zeros(R, 32), torch.zeros(R, 32))
    for k0 in range(0, S, 32):
        s = torch.arange(k0, k0 + 32)
        take = s < S
        sc = s.clamp(max=S - 1)
        part = (torch.where(take, counts[sc], 0).expand(R, 32), pm[:, sc], pq[:, sc])
        lanes = _chan(lanes, part)
    _, m, q = _tree(list(lanes), _chan)
    return m, torch.rsqrt((q / span).clamp(min=0) + eps)


def _channel_terms(mean, rstd, gamma, beta, groups, rows_n):
    """a = rstd·γ and b = β − a·mean (one rounding) [R, cpg]."""
    cpg = gamma.numel() // groups
    g = torch.arange(rows_n) % groups
    gm = gamma.float().view(groups, cpg)[g]
    a = rstd[:, None] * gm
    return a, _fma(-a, mean[:, None].expand_as(a), beta.float().view(groups, cpg)[g]), gm


def emulate_forward(x, gamma, beta, groups, eps, silu, real_rows=None):
    """The kernel pair's forward on x [N, C, H, W], split as for
    ``real_rows`` rows (default N·groups); (y, mean, rstd)."""
    n, c, h, w = x.shape
    hw, cpg = h * w, c // groups
    rows = x.float().reshape(n * groups, cpg * hw)
    chunk, _ = layers.kernel_split(real_rows or n * groups, cpg * hw)
    vec = 8 if hw % 8 == 0 else 1
    mean, rstd = emulate_stats(rows, chunk, vec, eps)
    a, b, _ = _channel_terms(mean, rstd, gamma, beta, groups, n * groups)
    v = _rnd(_fma(a[:, :, None], rows.view(-1, cpg, hw), b[:, :, None]))
    if silu:
        v = _rnd(v / (1.0 + torch.exp(-v)))
    return v.view(x.shape).to(torch.bfloat16), mean, rstd


def _cotangent(dy, v_in, a, b, silu):
    if not silu:
        return dy
    v = _rnd(_fma(a, v_in, b))
    sg = 1.0 / (1.0 + torch.exp(-v))
    return _rnd(dy * sg * _fma(v, 1.0 - sg, torch.ones_like(v)))


def emulate_backward(x, dy, gamma, beta, mean, rstd, groups, silu, real_rows=None):
    """dx of the kernel pair's backward, split as the forward; with the
    f64 evaluation of the same formula on the same cotangent."""
    n, c, h, w = x.shape
    hw, cpg = h * w, c // groups
    R, span = n * groups, cpg * hw
    chunk, _ = layers.kernel_split(real_rows or R, span)
    vec = 8 if hw % 8 == 0 else 1
    xr, gr = x.float().reshape(R, span), dy.float().reshape(R, span)
    a, b, gm = _channel_terms(mean, rstd, gamma, beta, groups, R)
    xv, valid, off = _thread_vectors(xr, chunk, vec, BWD_UNROLL)
    gv, _, _ = _thread_vectors(gr, chunk, vec, BWD_UNROLL)
    S, iters = valid.shape[:2]
    s1, s2 = torch.zeros(R, S, THREADS), torch.zeros(R, S, THREADS)
    for it in range(iters):
        ch = (off[:, it] // hw).clamp(max=cpg - 1)          # [S, BWD_UNROLL, THREADS]
        for u in range(BWD_UNROLL):
            ok = valid[:, it, u]
            cu = ch[:, u]
            au, bu, gu = a[:, cu], b[:, cu], gm[:, cu]      # [R, S, THREADS]
            for i in range(vec):
                xe, de = xv[:, :, it, u, :, i], gv[:, :, it, u, :, i]
                gg = gu * _cotangent(de, xe, au, bu, silu)
                s1 = torch.where(ok, _fma(gg, xe, s1), s1)
                s2 = torch.where(ok, s2 + gg, s2)
    warps = _tree([t.view(R, S, WARPS, 32) for t in (s1, s2)], _sums)
    p1, p2 = (t[..., 0] for t in warps)
    for wi in range(1, WARPS):
        p1, p2 = p1 + warps[0][..., wi], p2 + warps[1][..., wi]
    lanes = [torch.zeros(R, 32), torch.zeros(R, 32)]
    for k0 in range(0, S, 32):
        s = torch.arange(k0, k0 + 32)
        take = s < S
        sc = s.clamp(max=S - 1)
        lanes = [lanes[0] + torch.where(take, p1[:, sc], 0.0),
                 lanes[1] + torch.where(take, p2[:, sc], 0.0)]
    r1, r2 = _tree(lanes, _sums)
    inv = 1.0 / span
    c2 = (r2 * mean - r1) * rstd * rstd * rstd * inv
    c3 = -c2 * mean - r2 * rstd * inv
    g = _cotangent(gr.view(R, cpg, hw), xr.view(R, cpg, hw), a[:, :, None], b[:, :, None],
                   silu)
    dx = _rnd(_fma(c2[:, None, None], xr.view(R, cpg, hw), a[:, :, None] * g)
              + c3[:, None, None])
    # the same formula in f64 on the same cotangent and statistics
    gg64 = gm[:, :, None].double() * g.double()
    x64 = xr.view(R, cpg, hw).double()
    q1, q2 = (gg64 * x64).sum((1, 2)), gg64.sum((1, 2))
    m64, r64 = mean.double(), rstd.double()
    d2 = (q2 * m64 - q1) * r64 ** 3 / span
    d3 = -d2 * m64 - q2 * r64 / span
    dx64 = r64[:, None, None] * gm[:, :, None].double() * g.double() \
        + d2[:, None, None] * x64 + d3[:, None, None]
    return dx.view(x.shape).to(torch.bfloat16), dx64.view(x.shape)


# ------------------------------------------------------------- inputs
# (label, N·groups in the real call, cpg, H, W): the VAE encoder's first
# level (SD 1.5 at 512², SDXL at 1024², one image: 32 rows of 4 channels),
# the UNet's levels at CFG batch 2 (64 rows) from SDXL's 128² × 10 down to
# 8² × 40 and an up block's concatenated 8² × 80, and a ragged H·W
EMULATED = [
    ("vae_512", 32, 4, 512, 512), ("vae_1024", 32, 4, 1024, 1024),
    ("unet_128x10", 64, 10, 128, 128), ("unet_64x10", 64, 10, 64, 64),
    ("unet_32x20", 64, 20, 32, 32), ("unet_16x40", 64, 40, 16, 16),
    ("unet_8x40", 64, 40, 8, 8), ("unet_8x80", 64, 80, 8, 8),
    ("ragged_7x9", 64, 10, 7, 9),
]


def _inputs(cpg, h, w, rows=2, seed=0):
    """x [1, rows·cpg, H, W] ~ 3 + 2·N(0, 1) (a mean far from 0 tests the
    Welford merge), γ ~ 1 + N(0, 0.1²), β ~ N(0, 0.1²), dy ~ N(0, 1), bf16."""
    g = torch.Generator().manual_seed(seed)
    c = rows * cpg
    x = (3.0 + 2.0 * torch.randn(1, c, h, w, generator=g)).bfloat16()
    gamma = (1.0 + 0.1 * torch.randn(c, generator=g)).bfloat16()
    beta = (0.1 * torch.randn(c, generator=g)).bfloat16()
    dy = torch.randn(1, c, h, w, generator=g).bfloat16()
    return x, gamma, beta, dy


def _emulated_rows(real_rows, cpg, h, w):
    """Rows to emulate: one for the multi-megabyte VAE spans, two else."""
    return 1 if cpg * h * w >= 1 << 20 else 2


def _ulp_close(got, want, atol=0.0, share=4e-3, flips=0.0):
    """Every element within one bf16 ulp of ``want`` (2^-7 of it) + atol,
    fewer than ``share`` of them differing at all (None: any share); with
    ``flips``, fewer than 1 in 1,000 may exceed that by up to ``flips``
    (the backward: a recomputed SiLU cotangent one bf16 ulp apart, where the
    two forwards' outputs landed one ulp apart)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound = 2.0 ** -7 * want.abs() + atol
    assert bool((diff <= bound + flips).all()), float(diff.max())
    assert float((diff > bound).float().mean()) < 1e-3
    if share is not None:
        assert float((diff > 0).float().mean()) < share


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_forward_matches_chain_and_f64(case, silu):
    _, real_rows, cpg, h, w = case
    rows = _emulated_rows(real_rows, cpg, h, w)
    x, gamma, beta, _ = _inputs(cpg, h, w, rows)
    y, mean, rstd = emulate_forward(x, gamma, beta, rows, 1e-6, silu, real_rows)
    x64 = x.double().view(rows, -1)
    m64, v64 = x64.mean(1), x64.var(1, unbiased=False)
    spread = v64.sqrt()
    assert bool(((mean.double() - m64).abs() <= 1e-6 * spread).all())
    assert bool(((rstd.double() * (v64 + 1e-6).sqrt() - 1).abs() <= 1e-5).all())
    want = group_norm(x, rows, gamma, beta, 1e-6, silu)
    assert y.dtype == want.dtype == torch.bfloat16 and y.shape == want.shape
    _ulp_close(y, want, atol=2.0 ** -14 * float(want.float().abs().max()))


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_backward_matches_chain_autograd_and_f64(case, silu):
    _, real_rows, cpg, h, w = case
    rows = _emulated_rows(real_rows, cpg, h, w)
    x, gamma, beta, dy = _inputs(cpg, h, w, rows, seed=1)
    _, mean, rstd = emulate_forward(x, gamma, beta, rows, 1e-6, silu, real_rows)
    dx, dx64 = emulate_backward(x, dy, gamma, beta, mean, rstd, rows, silu, real_rows)
    xg = x.clone().requires_grad_(True)
    group_norm(xg, rows, gamma, beta, 1e-6, silu).backward(dy)
    want = xg.grad
    assert dx.dtype == want.dtype == torch.bfloat16
    scale = float(want.float().abs().max())
    _ulp_close(dx, want, atol=2.0 ** -12 * scale, flips=2.0 ** -7 * scale)
    _ulp_close(dx, dx64, atol=2.0 ** -12 * scale, share=None)


def test_emulation_pins_the_rounding_points():
    """Rounding the normalised value only after the SiLU (one rounding
    fewer than the chain) moves many outputs: the emulation's agreement
    with the chain is the rounding points', not an accident of tolerance."""
    x, gamma, beta, _ = _inputs(10, 16, 16, rows=2)
    y, mean, rstd = emulate_forward(x, gamma, beta, 2, 1e-6, True)
    a, b, _ = _channel_terms(mean, rstd, gamma, beta, 2, 2)
    v = _fma(a[:, :, None], x.float().view(2, 10, -1), b[:, :, None])
    once = _rnd(v / (1.0 + torch.exp(-v))).view(x.shape)
    want = group_norm(x, 2, gamma, beta, 1e-6, True).float()
    assert float(((once - want).abs() > 0).float().mean()) > 0.05
    _ulp_close(y, want)


# ------------------------------------------------------------ the split
@pytest.mark.parametrize("rows,span", [(32, 1 << 20), (32, 4 << 20), (64, 163840),
                                       (64, 40960), (64, 2560), (64, 5120), (1, 7),
                                       (65535, 64), (2, 630), (1, 2 ** 31 - 1)])
def test_kernel_split_covers_each_span_once(rows, span):
    chunk, splits = layers.kernel_split(rows, span)
    assert chunk % 8 == 0 and (splits - 1) * chunk < span <= splits * chunk
    assert splits == 1 or chunk >= layers.KERNEL_MIN_CHUNK
    assert rows * splits <= max(rows, layers.KERNEL_BLOCKS + rows)


def test_kernel_split_fills_the_card_for_the_vae_and_not_the_tiny_spans():
    assert layers.kernel_split(32, 1 << 20) == (16384, 64)      # 2,048 blocks
    assert layers.kernel_split(32, 4 << 20) == (65536, 64)
    assert layers.kernel_split(64, 2560) == (2560, 1)           # UNet at 8²


# -------------------------------------------------------------- route
@pytest.mark.parametrize("dtype,layout,trains,grad_mode,kernel", [
    (torch.bfloat16, "nchw", False, True, True),     # the editing VAE and UNet
    (torch.bfloat16, "nchw", True, False, True),     # a trainable γ under no_grad
    (torch.bfloat16, "nchw", True, True, False),     # a γ that trains
    (torch.float32, "nchw", False, False, False),    # the f32 UNet
    (torch.bfloat16, "f32_weights", False, False, False),
    # the same function in another layout: the route copies it to NCHW
    (torch.bfloat16, "channels_last", False, False, True),
    (torch.bfloat16, "sliced", False, False, True),
    # not 4-D: the kernel's check refuses it, loudly
    (torch.bfloat16, "3d", False, False, True),
])
def test_takes_kernel_on_dtype_grad_and_layout(dtype, layout, trains, grad_mode, kernel):
    norm = GroupNorm(4, 16).to(dtype).requires_grad_(trains)
    if layout == "f32_weights":
        norm.float()
    x = torch.randn(2, 16, 8, 8).to(dtype)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    elif layout == "sliced":
        x = torch.randn(2, 16, 8, 16).to(dtype)[..., ::2]
    elif layout == "3d":
        x = x.view(2, 16, 64)
    with torch.set_grad_enabled(grad_mode):
        assert layers.takes_kernel(x, norm.weight, norm.bias) is kernel


def test_group_norm_routes_each_input(monkeypatch):
    """On the card (faked) the kernel for bf16 inputs with a frozen bf16
    norm, with the SiLU flag passed on, a channels-last input as a
    contiguous NCHW copy; the chain and one ``group_norm_plain`` count for
    the others (f32, a norm that trains); on the CPU the chain, no count
    and no kernel library."""
    norm = GroupNorm(4, 16, eps=1e-6).bfloat16().requires_grad_(False)
    x = torch.randn(2, 16, 8, 8).bfloat16()
    count = spans.counters["group_norm_plain"]

    def no_library():
        raise AssertionError("a CPU input reached the kernel library")

    monkeypatch.setattr(layers.kernels, "library", no_library)
    for silu in (False, True):
        assert torch.equal(norm(x, silu=silu), group_norm(x, 4, norm.weight, norm.bias,
                                                          1e-6, silu))
    assert torch.equal(norm(x), F.group_norm(x.float(), 4, norm.weight.float(),
                                             norm.bias.float(), 1e-6).bfloat16())
    assert spans.counters["group_norm_plain"] == count

    calls = []
    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    monkeypatch.setattr(layers, "group_norm_kernel",
                        lambda *a: calls.append(a) or torch.zeros_like(a[0]))
    assert not norm(x, silu=True).any()
    assert len(calls) == 1 and calls[0][3:] == (4, 1e-6, True)
    norm(x.to(memory_format=torch.channels_last))
    assert len(calls) == 2 and calls[1][0].is_contiguous() and torch.equal(calls[1][0], x)
    assert spans.counters["group_norm_plain"] == count
    f32 = norm.float()
    assert f32(x.float()).dtype == torch.float32 and len(calls) == 2
    trained = GroupNorm(4, 16).bfloat16()
    out = trained(x, silu=True)
    assert out.requires_grad and len(calls) == 2
    assert torch.equal(out.detach(), group_norm(x, 4, trained.weight, trained.bias,
                                                1e-5, True))
    assert spans.counters["group_norm_plain"] == count + 2


TINY_UNET = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                 cross_attention_dim=32, attention_head_dim=4, norm_num_groups=8)
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8,
                sample_size=32)


def test_every_norm_of_the_unet_and_vae_takes_the_route_with_its_silu(monkeypatch):
    """The bf16 UNet and VAE encoder, on the card (faked), call the kernel
    once a GroupNorm module, none the chain: with the SiLU fused in every
    resnet block and ``conv_norm_out``, without it in
    ``Transformer2DModel.norm`` and ``VAEAttention.group_norm``; the outputs
    equal the chain's.  Every norm's input is already contiguous NCHW, a
    channels-last image included (the encoder casts it; the sums after
    attention keep the residual's layout), so no norm copies its input."""
    seen = []
    real = layers.group_norm

    def kernel(x, weight, bias, groups, eps, silu=False):
        seen.append(silu)
        return real(x, groups, weight, bias, eps, silu)

    g = torch.Generator().manual_seed(0)
    u = build(unet.UNet2DCondition, unet.UNetConfig(dtype="bfloat16", **TINY_UNET),
              generator=g).bfloat16().requires_grad_(False)
    v = build(vae.AutoencoderKL, vae.VAEConfig(dtype="bfloat16", **TINY_VAE),
              generator=g).bfloat16().requires_grad_(False)
    sample, ctx = torch.randn(2, 4, 16, 16, generator=g), torch.randn(2, 77, 32, generator=g)
    # a rendered frame comes in channels-last ([1, H, W, 3] permuted)
    image = torch.rand(1, 32, 32, 3, generator=g).permute(0, 3, 1, 2)
    plain = spans.counters["group_norm_plain"]
    with torch.no_grad():
        want = (u(sample, torch.tensor([10, 20]), ctx), v.moments(image)[0])
    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    monkeypatch.setattr(layers, "group_norm_kernel", kernel)
    inputs_nchw = []
    hooks = [m.register_forward_pre_hook(lambda m, a: inputs_nchw.append(a[0].is_contiguous()))
             for model in (u, v) for m in model.modules() if isinstance(m, GroupNorm)]
    try:
        with torch.no_grad():
            got = (u(sample, torch.tensor([10, 20]), ctx), v.moments(image)[0])
    finally:
        for h in hooks:
            h.remove()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(inputs_nchw) == len(seen) and all(inputs_nchw)
    assert spans.counters["group_norm_plain"] == plain
    names = [name for model in (u, v.encoder) for name, m in model.named_modules()
             if isinstance(m, GroupNorm)]
    fused = [n for n in names if n.endswith(("norm1", "norm2", "conv_norm_out"))]
    assert len(seen) == len(names)
    assert seen.count(True) == len(fused)
    assert seen.count(False) == len(names) - len(fused) \
        == sum(isinstance(m, unet.Transformer2DModel) for m in u.modules()) \
        + sum(isinstance(m, vae.VAEAttention) for m in v.encoder.modules())


@pytest.mark.parametrize("bad,error", [
    ("float32", TypeError), ("channels_last", ValueError), ("3d", ValueError),
    ("groups", ValueError), ("group_channels", ValueError), ("rows", ValueError),
    ("weight_shape", ValueError), ("no_bias", ValueError), ("f32_weight", TypeError),
    ("strided_bias", ValueError),
])
def test_check_kernel_refuses_what_the_kernel_does_not_take(bad, error):
    x = torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16)
    weight, bias, groups = (torch.ones(16, dtype=torch.bfloat16),
                            torch.zeros(16, dtype=torch.bfloat16), 4)
    if bad == "float32":
        x = x.float()
    elif bad == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    elif bad == "3d":
        x = x.view(2, 16, 64)
    elif bad == "groups":
        groups = 3
    elif bad == "group_channels":
        x = torch.zeros(1, 2 * (layers.KERNEL_MAX_GROUP_CHANNELS + 1), 1, 1,
                        dtype=torch.bfloat16)
        weight, bias, groups = x.new_ones(x.shape[1]), x.new_zeros(x.shape[1]), 2
    elif bad == "rows":
        x = torch.zeros(layers.KERNEL_MAX_ROWS // 4 + 1, 4, 1, 1, dtype=torch.bfloat16)
        weight, bias = x.new_ones(4), x.new_zeros(4)
    elif bad == "weight_shape":
        weight = x.new_ones(8)
    elif bad == "no_bias":
        bias = None
    elif bad == "f32_weight":
        weight = weight.float()
    elif bad == "strided_bias":
        bias = x.new_zeros(32)[::2]
    good = torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16)
    layers.check_kernel(good, good.new_ones(16), good.new_zeros(16), 4)   # it passes
    with pytest.raises(error, match="group_norm"):
        layers.check_kernel(x, weight, bias, groups)


# --------------------------------------------------------- state dict
def _keys(module):
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def test_state_dict_keys_are_diffusers_own():
    """The norms keep ``weight`` and ``bias``; the full-width SD 1.5 UNet and
    the VAE the reference's keys and shapes, SDXL's UNet its keys (its
    reference stores ``proj_in``/``proj_out`` as linear layers) (meta
    device)."""
    assert [k for k, _ in _keys(GroupNorm(32, 64))] == ["weight", "bias"]
    xl = build(unet.UNet2DCondition, unet.sdxl_unet_config(), device="meta")
    ref = ref_sd.build(ref_xl.UNet, ref_xl.UNetConfig(), device="meta")
    assert sorted(k for k, _ in _keys(xl)) == sorted(k for k, _ in _keys(ref))
    for port, ref in (
            (build(unet.UNet2DCondition, unet.UNetConfig(), device="meta"),
             ref_sd.build(ref_sd.UNet2DCondition, ref_sd.UNetConfig(), device="meta")),
            (build(vae.AutoencoderKL, vae.VAEConfig(), device="meta"),
             ref_sd.build(ref_sd.AutoencoderKL, ref_sd.VAEConfig(), device="meta"))):
        assert sorted(_keys(port)) == sorted(_keys(ref))


def test_norm_counts_of_the_full_width_stacks():
    """The GroupNorms a step runs (each a kernel forward on the card): SD
    1.5's UNet 61, SDXL's 46, the VAE encoder 22 (each also a backward)."""
    count = lambda m: sum(isinstance(x, GroupNorm) for x in m.modules())  # noqa: E731
    assert count(build(unet.UNet2DCondition, unet.UNetConfig(), device="meta")) == 61
    assert count(build(unet.UNet2DCondition, unet.sdxl_unet_config(), device="meta")) == 46
    assert count(build(vae.AutoencoderKL, vae.VAEConfig(), device="meta").encoder) == 22
