"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (ragged tails, strided views, an end-to-end encode backward).

Marked ``cuda``: they need a CUDA device and nvcc, and skip elsewhere.  Run
them on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (that
machine has no JAX, which ``tests/conftest.py`` imports).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SHAPES = [(72, 64), (64, 64), (64, 64), (64, 64), (64, 1), (91, 64), (64, 4)]
BLOCK_POINTS = 8 * 32       # points one K1 block takes a pass: 8 warps × 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mlp_problem(B, device, seed):
    rng = np.random.RandomState(seed)
    ws = [torch.tensor((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
                       device=device) for s in SHAPES]
    x = torch.tensor(rng.randn(B, 72).astype(np.float32), device=device)
    v = torch.tensor(rng.randn(B, 27).astype(np.float32), device=device)
    return x, v, ws


@pytest.mark.parametrize("with_rgb", [True, False])
@pytest.mark.parametrize("B", [1, 15, 16, 17, 31, 32, 33, BLOCK_POINTS - 1,
                               BLOCK_POINTS, BLOCK_POINTS + 1, 5000, 2 ** 20])
def test_fused_mlp_kernel_matches_plain(cuda, B, with_rgb):
    from customnerf_torch.ops import fused_mlp as fm
    from customnerf_torch.ops import kernels
    x, v, ws = _mlp_problem(B, cuda, B)
    d0 = kernels.device_launches("fused_mlp")
    sk, rk = fm.fused_mlp_forward(x, v, ws, with_rgb=with_rgb)
    sp, rp = fm.reference_forward(x, v, ws, with_rgb=with_rgb)
    torch.cuda.synchronize()
    d1 = kernels.device_launches("fused_mlp")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (1, 0)
    # split-TF32 against f32, another summation order: ≤ 1e-4 of O(1) outputs
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-4)
    if with_rgb:
        torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-4)
    else:
        assert rk is None and rp is None


def test_density_only_sigma_is_bitwise_the_full_calls(cuda):
    from customnerf_torch.ops import fused_mlp as fm
    x, v, ws = _mlp_problem(3001, cuda, 7)
    s_full, _ = fm.fused_mlp_forward(x, v, ws)
    s_dens, rgb = fm.fused_mlp_forward(x, None, ws, with_rgb=False)
    assert rgb is None
    assert torch.equal(s_full, s_dens)


@pytest.mark.parametrize("with_rgb", [True, False])
@pytest.mark.parametrize("B", [1, 17, BLOCK_POINTS - 1, BLOCK_POINTS + 1, 5000, 2 ** 20 + 3])
def test_fused_mlp_kernel_on_grid_features(cuda, B, with_rgb):
    """K1 at in_dim 32: the reference grid's 16 levels × 2 channels
    (``bear.sh --parity``), full head and density-only, ragged B."""
    from customnerf_torch.ops import fused_mlp as fm
    from customnerf_torch.ops import kernels
    rng = np.random.RandomState(B)
    shapes = [(32, 64)] + SHAPES[1:]
    ws = [torch.tensor((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
                       device=cuda) for s in shapes]
    x = torch.tensor(rng.randn(B, 32).astype(np.float32), device=cuda)
    v = torch.tensor(rng.randn(B, 27).astype(np.float32), device=cuda)
    d0 = kernels.device_launches("fused_mlp")
    sk, rk = fm.fused_mlp_forward(x, v, ws, with_rgb=with_rgb)
    sp, rp = fm.reference_forward(x, v, ws, with_rgb=with_rgb)
    torch.cuda.synchronize()
    d1 = kernels.device_launches("fused_mlp")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (1, 0)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-4)
    if with_rgb:
        torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-4)
    else:
        assert rk is None and torch.equal(fm.fused_mlp_forward(x, v, ws)[0], sk)


@pytest.mark.parametrize("with_rgb", [True, False])
@pytest.mark.parametrize("in_dim", [72, 32])
@pytest.mark.parametrize("B", [1, 17, 33, BLOCK_POINTS + 1, 5000, 2 ** 20 + 3])
def test_fused_mlp_bf16_kernel_matches_plain(cuda, B, in_dim, with_rgb):
    """K1's bf16 mode (the flax bf16 head) against ``reference_forward(...,
    dtype=torch.bfloat16)`` (cuBLAS bf16 GEMMs): ≤ 1e-2 of the largest
    output, about 2.5 bf16 ulps, since the two sum each layer in another
    order and a sum near a rounding boundary lands one ulp apart; the
    outputs are bf16 values; density-only sigma is the full call's."""
    from customnerf_torch.ops import fused_mlp as fm
    rng = np.random.RandomState(B + in_dim)
    shapes = [(in_dim, 64)] + SHAPES[1:]
    ws = [torch.tensor((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
                       device=cuda) for s in shapes]
    x = torch.tensor(rng.randn(B, in_dim).astype(np.float32), device=cuda)
    v = torch.tensor(rng.randn(B, 27).astype(np.float32), device=cuda)
    from customnerf_torch.ops import kernels
    d0 = kernels.device_launches("fused_mlp")
    sk, rk = fm.fused_mlp_forward(x, v, ws, with_rgb=with_rgb, bf16=True)
    sp, rp = fm.reference_forward(x, v, ws, with_rgb=with_rgb, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    d1 = kernels.device_launches("fused_mlp")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (0, 1)
    outs = [(sk, sp)] + ([(rk, rp)] if with_rgb else [])
    scale = max(float(p.abs().max()) for _, p in outs)
    for k, p in outs:
        assert torch.equal(k, k.to(torch.bfloat16).float())
        torch.testing.assert_close(k, p, rtol=0, atol=1e-2 * scale)
    if not with_rgb:
        assert rk is None and torch.equal(
            fm.fused_mlp_forward(x, v, ws, bf16=True)[0], sk)


SMALL_GRID = dict(num_levels=16, base_resolution=16, log2_hashmap_size=15,
                  desired_resolution=1024)
PARITY_GRID = dict(num_levels=16, level_dim=2, base_resolution=16, log2_hashmap_size=21,
                   desired_resolution=8192, gridtype="tiled")
# (spec, max_level, points along rays): C = 2 tiled, hash (its coarse
# levels dense: some levels hash, some do not), a spec whose levels all
# hash but the first, C = 1, 4, 8, levels cut by max_level, and the cell's
# own spec on 200,000 points along rays (runs of samples sharing corners)
GRID_CASES = {
    "tiled": (dict(SMALL_GRID, level_dim=2, gridtype="tiled"), None, False),
    "hash": (dict(SMALL_GRID, level_dim=2, gridtype="hash"), None, False),
    "mixed": (dict(SMALL_GRID, level_dim=2, gridtype="hash", log2_hashmap_size=13), None, False),
    "C1": (dict(SMALL_GRID, level_dim=1, gridtype="tiled"), None, False),
    "C4": (dict(SMALL_GRID, level_dim=4, gridtype="hash"), None, False),
    "C8": (dict(SMALL_GRID, level_dim=8, gridtype="hash"), None, False),
    "max_level": (dict(SMALL_GRID, level_dim=2, gridtype="hash"), 5, False),
    "parity": (PARITY_GRID, None, True),
}


def _grid_points(rng, along_rays):
    """20,000 uniform points, or 200,000 along 3,125 rays of 64 samples; some
    outside [0, 1] either way."""
    if not along_rays:
        return (rng.rand(20000, 3) * 1.1 - 0.05).astype(np.float32)
    o = rng.rand(3125, 1, 3)
    d = rng.randn(3125, 1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0.0, 0.5, 64)[None, :, None]
    return (o + t * d).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_encode_on_card_matches_cpu(cuda, case):
    """The kernels (``csrc/grid_encode.cu``) against the plain encoder on the
    CPU: the output, the table gradient and dx, with points outside [0, 1];
    one forward and one backward launch, as the kernels count them.  Tolerance: forward
    rtol 1e-5 (the same products, summed in the same order, on another
    machine); gradients 1e-5 of the largest entry (atomics add in an order
    that varies; merged runs sum in another order)."""
    from customnerf_torch.ops import kernels
    from customnerf_torch.ops.grid import GridSpec, grid_encode
    kw, max_level, along_rays = GRID_CASES[case]
    spec = GridSpec(**kw)
    rng = np.random.RandomState(len(case))
    table = torch.tensor(rng.rand(spec.table_size, spec.level_dim).astype(np.float32) * 2 - 1)
    x = torch.tensor(_grid_points(rng, along_rays))
    g = torch.tensor(rng.randn(x.shape[0], spec.output_dim).astype(np.float32))

    def run(dev):
        t = table.to(dev).clone().requires_grad_(True)
        xx = x.to(dev).clone().requires_grad_(True)
        out = grid_encode(xx, t, spec, max_level=max_level)
        (out * g.to(dev)).sum().backward()
        return out.detach().cpu(), t.grad.cpu(), xx.grad.cpu()

    d0 = kernels.device_launches("grid_encode")
    card = run(cuda)
    d1 = kernels.device_launches("grid_encode")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (1, 1)
    want = run("cpu")
    outside = ((x < 0) | (x > 1)).any(-1)
    assert outside.sum() > 10 and not card[0][outside].any() and not card[2][outside].any()
    if max_level is not None:
        assert not card[0][:, max_level * spec.level_dim:].any()
    torch.testing.assert_close(card[0], want[0], rtol=1e-5,
                               atol=1e-5 * float(want[0].abs().max()))
    for got, w in zip(card[1:], want[1:]):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def test_grid_encode_graph_replay_matches_eager(cuda):
    """Forward and backward captured in a CUDA graph: a replay gives the
    eager output bit for bit and its table gradient within 1e-5 of the
    largest entry (atomic order); the kernels count the replay's launches."""
    from customnerf_torch.ops import kernels
    from customnerf_torch.ops.grid import GridSpec, grid_encode
    spec = GridSpec(**PARITY_GRID)
    rng = np.random.RandomState(3)
    table = torch.tensor(rng.rand(spec.table_size, 2).astype(np.float32) * 2 - 1, device=cuda)
    x = torch.tensor(_grid_points(rng, True), device=cuda)
    g = torch.tensor(rng.randn(x.shape[0], spec.output_dim).astype(np.float32), device=cuda)
    t = table.clone().requires_grad_(True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            t.grad = None
            grid_encode(x, t, spec).backward(g)
    torch.cuda.current_stream().wait_stream(side)
    t.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = grid_encode(x, t, spec)
        out.backward(g)
    d0 = kernels.device_launches("grid_encode")
    graph.replay()
    d1 = kernels.device_launches("grid_encode")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (1, 1)
    got_out, got_dt = out.clone(), t.grad.clone()
    e = table.clone().requires_grad_(True)
    want = grid_encode(x, e, spec)
    want.backward(g)
    assert torch.equal(got_out, want.detach())
    scale = float(e.grad.abs().max())
    torch.testing.assert_close(got_dt, e.grad, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("bad", ["level_dim", "dtype"])
def test_grid_encode_kernel_rejects_what_it_does_not_take(cuda, bad):
    """A CUDA tensor launches the kernels or raises: a C the kernels are not
    built for, or a table that is not f32, never falls back."""
    from customnerf_torch.ops.grid import GridSpec, grid_encode
    C = 3 if bad == "level_dim" else 2
    spec = GridSpec(**dict(SMALL_GRID, level_dim=C, gridtype="hash"))
    table = torch.zeros(spec.table_size, C, device=cuda)
    if bad == "dtype":
        table = table.to(torch.bfloat16)
    x = torch.rand(100, 3, device=cuda)
    with pytest.raises((ValueError, TypeError), match="grid_encode"):
        grid_encode(x, table, spec)


# ---------------------------------------------------------------- attention
# (b, n, heads, d, sharpness) of the attention calls on the main path:
# SD 1.5's four levels, SDXL's two attending levels (the mid block is level
# 2's shape), FLUX.1-dev's joint attention (4,096 image + 512 text tokens,
# 24 heads of 128), a ragged n, multi-scene editing's batch 2S at S = 2,
# peaked rows (logits ~ N(0, 9)), and every head width the kernel takes
ATTENTION_CASES = {
    "sd15_l0": (2, 4096, 8, 40, 1.0), "sd15_l1": (2, 1024, 8, 80, 1.0),
    "sd15_l2": (2, 256, 8, 160, 1.0), "sd15_l3": (2, 64, 8, 160, 1.0),
    "sdxl_l1": (2, 4096, 10, 64, 1.0), "sdxl_l2": (2, 1024, 20, 64, 1.0),
    "flux_joint": (1, 4608, 24, 128, 1.0),
    "ragged_n": (2, 1000, 8, 40, 1.0), "scenes2": (4, 4096, 8, 40, 1.0),
    "peaked": (2, 1024, 8, 40, 3.0),
    **{f"d{d}": (1, 200, 2, d, 1.0) for d in range(8, 161, 8)},
}


def _attention_inputs(b, n, m, heads, d, device, sharp=1.0, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k = (sharp * torch.randn(b, r, heads * d, device=device, generator=g)
            for r in (n, m))
    v = torch.randn(b, m, heads * d, device=device, generator=g)
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def _attention_close(got, want, v):
    """Kernel against the plain path, both in bf16.  Both round the
    normalised probabilities to bf16 and the f32 output once; the logits'
    and the sums' f32 orders differ (tensor cores against SIMT GEMMs, an
    online sum), so a probability near a rounding boundary may land one ulp
    (≤ 2^-8) apart, moving an output by ≤ 2^-8 of the largest |v|, and the
    output's own rounding then by one ulp (2^-7 of it); such flips are
    rare: fewer than 1 % of the outputs may differ at all."""
    diff = (got.float() - want.float()).abs()
    bound = 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * float(v.float().abs().max())
    share = float((diff > 0).float().mean())
    assert bool((diff <= bound).all()), f"max error {float(diff.max())}"
    assert share < 1e-2, f"{share:.4f} of the outputs differ"


@pytest.mark.parametrize("keys", ["self", "cross"])
@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_kernel_matches_plain(cuda, case, keys):
    """The kernel against the plain ``attention`` in bf16 at each shape of
    the main path, as self-attention (m = n) and against 77 context keys;
    written straight into [b, n, h·d], one launch counted by the kernel
    (a masked last key tile where m is not a multiple of 64)."""
    from customnerf_torch.guidance import unet
    from customnerf_torch.ops import kernels
    b, n, heads, d, sharp = ATTENTION_CASES[case]
    m = n if keys == "self" else 77
    q, k, v = _attention_inputs(b, n, m, heads, d, cuda, sharp)
    d0 = kernels.device_launches("attention")
    with torch.no_grad():
        got = unet.attend(q, k, v, heads)
        want = unet.attention(q, k, v, heads)
    d1 = kernels.device_launches("attention")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == ((0, 1) if m % 64 else (1, 0))
    assert got.shape == (b, n, heads * d) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    _attention_close(got, want, v)


def test_attention_kernel_graph_replay_takes_new_inputs(cuda):
    """attend captured in a CUDA graph: a replay on new inputs copied in
    gives the eager kernel's output bit for bit, and the kernel counts the
    replay's launch."""
    from customnerf_torch.guidance import unet
    from customnerf_torch.ops import kernels
    q, k, v = _attention_inputs(2, 1024, 77, 8, 40, cuda, seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        for _ in range(2):
            unet.attend(q, k, v, 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = unet.attend(q, k, v, 8)
    for t, new in zip((q, k, v), _attention_inputs(2, 1024, 77, 8, 40, cuda, seed=2)):
        t.copy_(new)
    d0 = kernels.device_launches("attention")
    graph.replay()
    d1 = kernels.device_launches("attention")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (0, 1)
    assert torch.equal(out, unet.attention_kernel(q, k, v, 8))


def test_attention_kernel_under_cd_kv(cuda):
    """``--use_cd`` editing: cross-attention whose K and V come from the
    Custom Diffusion adapters (f32 master weights that require grad, cast at
    use) takes the kernel under no_grad, as the SDS call runs it; with grad
    mode on (tuning) the same call takes the plain path and is counted."""
    import torch.nn.functional as F
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance import unet
    from customnerf_torch.ops import kernels
    attn = unet.Attention(320, 8, 40, context_dim=768).to(cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 4096, 320, device=cuda, generator=g).bfloat16()
    ctx = torch.randn(2, 77, 768, device=cuda, generator=g).bfloat16()
    cd_kv = {name: (torch.randn(320, 768, device=cuda, generator=g) / 768 ** 0.5)
             .requires_grad_(True) for name in ("to_k", "to_v")}
    n0, plain0 = sum(kernels.device_launches("attention")), spans.counters["attention_plain"]
    with torch.no_grad():
        got = attn(x, ctx, cd_kv)
        q = attn.to_q(x)
        k, v = (F.linear(ctx, cd_kv[n].to(torch.bfloat16)) for n in ("to_k", "to_v"))
        fused = unet.attention_kernel(q, k, v, 8)
        assert torch.equal(got, attn.to_out[0](fused))
        _attention_close(fused, unet.attention(q, k, v, 8), v)
    assert sum(kernels.device_launches("attention")) == n0 + 2
    tuned = attn(x, ctx, cd_kv)
    assert tuned.requires_grad and spans.counters["attention_plain"] == plain0 + 1
    assert sum(kernels.device_launches("attention")) == n0 + 2


def test_attention_plain_route_for_f32_and_grad_inputs(cuda):
    """f32 inputs (the f32 UNet) and bf16 inputs that autograd must
    differentiate take the unchanged plain function: no kernel launch, one
    ``attention_plain`` count each, the plain output bit for bit; the f32
    UNet's forward launches no kernel and counts each of its calls."""
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance import unet
    from customnerf_torch.ops import kernels
    q, k, v = _attention_inputs(2, 256, 77, 8, 40, cuda)
    d0, plain0 = kernels.device_launches("attention"), spans.counters["attention_plain"]
    f32 = [t.float() for t in (q, k, v)]
    with torch.no_grad():
        assert torch.equal(unet.attend(*f32, 8), unet.attention(*f32, 8))
    kg = k.clone().requires_grad_(True)
    out = unet.attend(q, kg, v, 8)
    out.float().sum().backward()
    assert kg.grad is not None and torch.equal(out.detach(), unet.attention(q, k, v, 8))
    assert spans.counters["attention_plain"] == plain0 + 2
    f32_unet = unet.UNet2DCondition(unet.UNetConfig(**TINY_UNET)).to(cuda)
    with torch.no_grad():
        f32_unet(torch.randn(2, 4, 16, 16, device=cuda), torch.tensor([10, 20], device=cuda),
                 torch.randn(2, 77, 32, device=cuda))
    calls = sum(isinstance(m, unet.Attention) for m in f32_unet.modules())
    assert calls == 20 and spans.counters["attention_plain"] == plain0 + 2 + calls
    assert kernels.device_launches("attention") == d0


@pytest.mark.parametrize("bad", ["head_12", "head_168", "misaligned"])
def test_attention_kernel_rejects_what_it_does_not_take(cuda, bad):
    """A CUDA bf16 input that needs no gradient launches the kernel or
    raises: never the plain path."""
    from customnerf_torch.guidance import unet
    from customnerf_torch.ops import kernels
    d = {"head_12": 12, "head_168": 168}.get(bad, 40)
    q, k, v = _attention_inputs(2, 128, 77, 2, d, cuda)
    if bad == "misaligned":
        q = torch.zeros(2 * 128 * 80 + 8, dtype=torch.bfloat16, device=cuda)[4:4 + 2 * 128 * 80]
        q = q.view(2, 128, 80)
    d0 = kernels.device_launches("attention")
    with torch.no_grad(), pytest.raises(ValueError, match="attention"):
        unet.attend(q, k, v, 2)
    assert kernels.device_launches("attention") == d0


@pytest.mark.parametrize("version,latent,per_call", [("1.5", 64, 32), ("xl", 128, 140)])
def test_graphed_unet_call_launches_the_kernel_for_every_attention(cuda, version, latent,
                                                                   per_call):
    """The bf16 UNet at published widths (SD 1.5, SDXL base) on the SDS
    call's CFG batch 2, captured in a CUDA graph and replayed: every
    attention call is a kernel launch (16 transformer blocks × 2 in SD 1.5,
    70 in SDXL), half of them against 77 context keys, none plain."""
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance import unet
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.ops import kernels
    cfg = (unet.UNetConfig(dtype="bfloat16") if version == "1.5"
           else unet.sdxl_unet_config("bfloat16"))
    model = build(unet.UNet2DCondition, cfg, device=cuda,
                  generator=torch.Generator(device=cuda).manual_seed(0))
    model = model.to(torch.bfloat16).eval().requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 4, latent, latent, device=cuda, generator=g)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, device=cuda, generator=g)
    t = torch.tensor([500, 500], device=cuda)
    kw = {}
    if cfg.addition_embed_type:
        kw["added_cond"] = {"text_embeds": torch.randn(2, cfg.text_embeds_dim, device=cuda,
                                                       generator=g),
                            "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                                                     device=cuda)}
    plain0 = spans.counters["attention_plain"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        eager = model(x, t, ctx, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = model(x, t, ctx, **kw)
    d0 = kernels.device_launches("attention")
    for _ in range(3):
        graph.replay()
    d1 = kernels.device_launches("attention")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (3 * per_call // 2, 3 * per_call // 2)
    assert spans.counters["attention_plain"] == plain0
    assert torch.equal(out, eager) and bool(torch.isfinite(out).all())


def test_graphed_flux_call_launches_the_kernel_for_every_attention(cuda):
    """The bf16 FLUX.1-dev transformer at published widths on the SDS call
    (batch 1, 128² × 16 latents: 4,096 image tokens, 512 text tokens),
    captured in a CUDA graph and replayed: one joint-attention launch a
    block, 57 a call, each over 4,608 keys (whole 64-key tiles), none plain;
    the replay equal to the eager call."""
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance.flux import FluxConfig, FluxTransformer
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.ops import kernels
    cfg = FluxConfig(dtype="bfloat16")
    model = build(FluxTransformer, cfg, device=cuda, dtype=torch.bfloat16,
                  generator=torch.Generator(device=cuda).manual_seed(0))
    model = model.eval().requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(1)
    args = (torch.randn(1, 16, 128, 128, device=cuda, generator=g),
            torch.tensor([0.7], device=cuda),
            torch.randn(1, 512, cfg.joint_attention_dim, device=cuda, generator=g),
            torch.randn(1, cfg.pooled_projection_dim, device=cuda, generator=g),
            torch.tensor([3.5], device=cuda))
    plain0 = spans.counters["attention_plain"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        eager = model(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = model(*args)
    d0 = kernels.device_launches("attention")
    for _ in range(3):
        graph.replay()
    d1 = kernels.device_launches("attention")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (3 * 57, 0)
    assert spans.counters["attention_plain"] == plain0
    assert torch.equal(out, eager) and bool(torch.isfinite(out).all())
    del model, graph
    torch.cuda.empty_cache()


# --------------------------------------------------------------- group norm
GN_STACKS = ["SD 1.5 UNet", "SD 1.5 VAE encoder", "SDXL UNet", "SDXL VAE encoder"]


def _gn_shapes(stack, batch):
    """The distinct (shape at ``batch``, groups, eps) of ``stack``'s
    GroupNorm calls (``chip_smoke.group_norm_calls``, on the meta device)."""
    import chip_smoke
    return sorted({((batch,) + shape[1:], groups, eps)
                   for shape, groups, eps, _ in chip_smoke.group_norm_calls(stack)})


def _gn_check(shape, groups, eps, silu, seed=0):
    """Forward and backward of the kernels against the chain (forward under
    no_grad, dx against autograd of the chain), at ``chip_smoke``'s
    tolerance; one forward and one backward launch counted, none plain."""
    import chip_smoke
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance import layers
    from customnerf_torch.ops import kernels
    x, gamma, beta, dy = chip_smoke.group_norm_inputs(shape, seed)
    d0, plain0 = kernels.device_launches("group_norm"), spans.counters["group_norm_plain"]
    norm = layers.GroupNorm(groups, shape[1], eps=eps).to(x.device, torch.bfloat16)
    norm.weight.data.copy_(gamma)
    norm.bias.data.copy_(beta)
    norm.requires_grad_(False)
    with torch.no_grad():
        got, want = norm(x, silu=silu), layers.group_norm(x, groups, gamma, beta, eps, silu)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape and got.is_contiguous()
    e = chip_smoke.group_norm_error(got, want, backward=False, silu=silu)
    assert chip_smoke.group_norm_ok(e), (shape, silu, "forward", e)
    xg = x.clone().requires_grad_(True)
    (got_dx,) = torch.autograd.grad(norm(xg, silu=silu), xg, dy)
    (want_dx,) = torch.autograd.grad(layers.group_norm(xg, groups, gamma, beta, eps, silu),
                                     xg, dy)
    e = chip_smoke.group_norm_error(got_dx, want_dx, backward=True, silu=silu)
    assert chip_smoke.group_norm_ok(e), (shape, silu, "backward", e)
    d1 = kernels.device_launches("group_norm")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (2, 1)
    assert spans.counters["group_norm_plain"] == plain0


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("stack", GN_STACKS)
def test_group_norm_kernel_matches_chain(cuda, stack, batch):
    """The kernels against the plain chain at every GroupNorm shape of the
    SD 1.5 and SDXL UNets and VAE encoders at published widths, at batch 1,
    2 and 4, forward with the SiLU on and off and backward (dx)."""
    for shape, groups, eps in _gn_shapes(stack, batch):
        for silu in (False, True):
            _gn_check(shape, groups, eps, silu)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape,groups", [
    ((2, 320, 7, 9), 32),        # H·W not a multiple of 8: one element at a time
    ((1, 128, 33, 31), 32),      # a ragged VAE-like span that still splits
    ((3, 64, 1, 1), 32),         # two elements a row
    ((2, 2560, 5, 5), 32),       # 80 channels a group, 2,000 elements a row
    ((1, 96, 512, 3), 3),        # 32 channels a group of 1,536 elements each
])
def test_group_norm_kernel_ragged_spans(cuda, shape, groups):
    for silu in (False, True):
        _gn_check(shape, groups, 1e-6, silu, seed=3)


def test_group_norm_kernel_refuses_f32_weights_and_takes_misaligned_input(cuda):
    """f32 γ and β are refused (the kernel reads bf16 ones); a bf16 input
    whose base is 2 bytes off 16 (the element-wise path) gives the chain's
    result."""
    import chip_smoke
    from customnerf_torch.guidance import layers
    x, gamma, beta, _ = chip_smoke.group_norm_inputs((2, 64, 16, 16), seed=4)
    with pytest.raises(TypeError, match="group_norm"):
        layers.group_norm_kernel(x, gamma.float(), beta.float(), 32, 1e-5, True)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    with torch.no_grad():
        got = layers.group_norm_kernel(shifted, gamma, beta, 32, 1e-5, True)
    e = chip_smoke.group_norm_error(got, layers.group_norm(shifted, 32, gamma, beta, 1e-5,
                                                           True),
                                    backward=False, silu=True)
    assert chip_smoke.group_norm_ok(e), e


def test_group_norm_kernel_graph_replays_are_bit_identical(cuda):
    """Forward and backward captured in a CUDA graph: three replays give
    the same bits, equal to an eager call's, with new inputs copied in; the
    kernels count each replay's launches."""
    import chip_smoke
    from customnerf_torch.guidance import layers
    from customnerf_torch.ops import kernels
    shape = (1, 128, 256, 256)
    x, gamma, beta, dy = chip_smoke.group_norm_inputs(shape, seed=5)
    xg = x.clone().requires_grad_(True)

    def step():
        y = layers.group_norm_kernel(xg, gamma, beta, 32, 1e-6, True)
        (dx,) = torch.autograd.grad(y, xg, dy)
        return y, dx

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, dx = step()
    new_x, _, _, new_dy = chip_smoke.group_norm_inputs(shape, seed=6)
    with torch.no_grad():
        xg.copy_(new_x)
    dy.copy_(new_dy)
    d0 = kernels.device_launches("group_norm")
    outs = []
    for _ in range(3):
        graph.replay()
        outs.append((y.clone(), dx.clone()))
    d1 = kernels.device_launches("group_norm")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (3, 3)
    eager = step()
    for out in outs:
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def test_group_norm_plain_route_on_the_card(cuda):
    """f32 inputs and norms whose γ trains take the unchanged chain on the
    card, one ``group_norm_plain`` count each, no kernel launch; a
    channels-last bf16 input (the same function in another layout) takes
    the kernel on a contiguous copy, forward and backward, with no count."""
    import chip_smoke
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance import layers
    from customnerf_torch.ops import kernels
    x, _, _, _ = chip_smoke.group_norm_inputs((2, 64, 16, 16), seed=7)
    frozen = layers.GroupNorm(32, 64).to(cuda, torch.bfloat16).requires_grad_(False)
    trains = layers.GroupNorm(32, 64).to(cuda, torch.bfloat16)
    d0, plain0 = kernels.device_launches("group_norm"), spans.counters["group_norm_plain"]
    with torch.no_grad():
        f32 = frozen.float()(x.float(), silu=True)
        assert torch.equal(f32, layers.group_norm(x.float(), 32, frozen.weight, frozen.bias,
                                                  1e-5, True))
    out = trains(x, silu=True)
    out.float().sum().backward()
    assert trains.weight.grad is not None
    assert spans.counters["group_norm_plain"] == plain0 + 2
    assert kernels.device_launches("group_norm") == d0
    frozen.bfloat16()
    dy = torch.randn_like(x)
    xg = x.to(memory_format=torch.channels_last).requires_grad_(True)
    cl = frozen(xg, silu=True)
    (got_dx,) = torch.autograd.grad(cl, xg, dy)
    xw = x.clone().requires_grad_(True)
    want = layers.group_norm(xw, 32, frozen.weight, frozen.bias, 1e-5, True)
    (want_dx,) = torch.autograd.grad(want, xw, dy)
    for got, ref, backward in ((cl, want, False), (got_dx, want_dx, True)):
        e = chip_smoke.group_norm_error(got, ref, backward=backward, silu=True)
        assert chip_smoke.group_norm_ok(e), (backward, e)
    d1 = kernels.device_launches("group_norm")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (1, 1)
    assert spans.counters["group_norm_plain"] == plain0 + 2


@pytest.mark.parametrize("version,latent,per_call", [("1.5", 64, 61), ("xl", 128, 46)])
def test_graphed_unet_and_vae_launch_the_kernel_for_every_group_norm(cuda, version, latent,
                                                                     per_call):
    """The bf16 UNet at published widths on the SDS call's CFG batch 2,
    captured in a CUDA graph and replayed: one forward launch a GroupNorm
    (61 in SD 1.5, 46 in SDXL); the bf16 VAE encoder forward and backward at
    its side on one image: 22 forwards and 22 backwards; none plain."""
    from customnerf_torch.engine import spans
    from customnerf_torch.guidance import sds, unet
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.vae import AutoencoderKL
    from customnerf_torch.ops import kernels
    cfg = dataclasses.replace(sds.unet_config(version), dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = build(unet.UNet2DCondition, cfg, device=cuda, generator=gen)
    model = model.to(torch.bfloat16).eval().requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 4, latent, latent, device=cuda, generator=g)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, device=cuda, generator=g)
    t = torch.tensor([500, 500], device=cuda)
    kw = {}
    if cfg.addition_embed_type:
        kw["added_cond"] = {"text_embeds": torch.randn(2, cfg.text_embeds_dim, device=cuda,
                                                       generator=g),
                            "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                                                     device=cuda)}
    plain0 = spans.counters["group_norm_plain"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        eager = model(x, t, ctx, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = model(x, t, ctx, **kw)
    d0 = kernels.device_launches("group_norm")
    for _ in range(3):
        graph.replay()
    d1 = kernels.device_launches("group_norm")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (3 * per_call, 0)
    assert torch.equal(out, eager) and bool(torch.isfinite(out).all())
    del model, graph, out, eager
    vcfg = dataclasses.replace(sds.vae_config(version), dtype="bfloat16")
    vae = build(AutoencoderKL, vcfg, device=cuda, generator=gen)
    vae = vae.to(torch.bfloat16).eval().requires_grad_(False)
    side_len = vcfg.sample_size
    image = torch.rand(1, 3, side_len, side_len, device=cuda, generator=g).requires_grad_(True)
    d0 = kernels.device_launches("group_norm")
    mean, _ = vae.moments(image)
    mean.float().square().sum().backward()
    d1 = kernels.device_launches("group_norm")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (22, 22)
    assert image.grad is not None and bool(torch.isfinite(image.grad).all())
    assert spans.counters["group_norm_plain"] == plain0


def _dtable_inputs(rng, B, R, C, device, ld=None):
    u0 = torch.tensor(rng.randint(0, R - 1, B).astype(np.int32), device=device)
    v0 = torch.tensor(rng.randint(0, R - 1, B).astype(np.int32), device=device)
    fu = torch.tensor(rng.rand(B).astype(np.float32), device=device)
    fv = torch.tensor(rng.rand(B).astype(np.float32), device=device)
    g = torch.tensor(rng.randn(B, ld or C).astype(np.float32), device=device)
    return u0, v0, fu, fv, g


@pytest.mark.parametrize("R,C", [(16, 4), (128, 16), (512, 8)])
def test_dtable_kernel_matches_plain_into_view(cuda, R, C):
    from customnerf_torch.ops import triplane_kernels as tk
    rng = np.random.RandomState(R + C)
    B = 3001
    u0, v0, fu, fv, gfull = _dtable_inputs(rng, B, R, C, cuda, ld=C + 8)
    gfull[::3] = 0.0          # dead compaction slots: the kernel skips them
    u0[::3] = v0[::3] = R // 2
    g = gfull[:, 4:C + 4]                       # 16-byte aligned column slice
    flat = torch.zeros(4 + R * R, 16, device=cuda)
    got = tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=flat[4:4 + R * R])
    want = tk.plane_dtable_reference(u0, v0, fu, fv, g.contiguous(), R, C)
    torch.cuda.synchronize()
    # atomics sum in a varying order: a few ulp of the row sums
    torch.testing.assert_close(got[:, :C], want, rtol=1e-5, atol=1e-5)
    assert float(flat[:4].abs().max()) == 0.0
    assert not flat[:, C:].any()


@pytest.mark.parametrize("bad", ["g_offset", "g_stride", "out_offset", "C"])
def test_dtable_kernel_rejects_misaligned_inputs(cuda, bad):
    from customnerf_torch.ops import triplane_kernels as tk
    rng = np.random.RandomState(0)
    R, C, B = 16, 8, 100
    u0, v0, fu, fv, gfull = _dtable_inputs(rng, B, R, C, cuda, ld=C + 8)
    g, out = gfull[:, :C], torch.zeros(R * R + 1, 16, device=cuda)[:R * R]
    if bad == "g_offset":
        g = gfull[:, 1:C + 1]                  # 4-byte offset
    elif bad == "g_stride":
        g = torch.zeros(B, C + 2, device=cuda)[:, :C]
    elif bad == "out_offset":
        out = torch.zeros(R * R * 16 + 1, device=cuda)[1:].view(R * R, 16)
    else:
        C, g = 6, gfull[:, :6]
    with pytest.raises(ValueError, match="kernel needs"):
        tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=out)


@pytest.mark.parametrize("R,C", [(128, 16), (512, 8)])
def test_dtable_kernel_on_runs_along_rays(cuda, R, C):
    """Runs of 8-40 consecutive samples in one cell (as along a ray),
    all-zero runs between them, and runs that cross thread boundaries."""
    from customnerf_torch.ops import triplane_kernels as tk
    rng = np.random.RandomState(R)
    lengths = rng.randint(8, 41, 400)
    cells = rng.randint(0, R - 1, (400, 2))
    u0 = np.repeat(cells[:, 0], lengths).astype(np.int32)
    v0 = np.repeat(cells[:, 1], lengths).astype(np.int32)
    B = u0.shape[0]
    g = rng.randn(B, C).astype(np.float32)
    ends = np.cumsum(lengths)
    for i in range(0, 400, 5):                  # every fifth run is dead
        g[ends[i] - lengths[i]:ends[i]] = 0.0
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    args = (t(u0), t(v0), t(rng.rand(B).astype(np.float32)),
            t(rng.rand(B).astype(np.float32)), t(g))
    got = tk.plane_dtable(*args, R, C)
    want = tk.plane_dtable_reference(*args, R, C)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("R,C", [(16, 4), (128, 16), (512, 8)])
def test_dtable_bf16_kernel_matches_plain(cuda, R, C):
    """dT's bf16 mode against its plain version, into a view, with dead
    slots and runs along rays: the same roundings, the f32 sums in another
    order: ≤ 1e-5 of the largest texel sum; the f32 mode differs."""
    from customnerf_torch.ops import triplane_kernels as tk
    rng = np.random.RandomState(R + C + 1)
    lengths = rng.randint(1, 41, 300)
    cells = rng.randint(0, R - 1, (300, 2))
    B = int(lengths.sum())
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    u0 = t(np.repeat(cells[:, 0], lengths).astype(np.int32))
    v0 = t(np.repeat(cells[:, 1], lengths).astype(np.int32))
    fu, fv = t(rng.rand(B).astype(np.float32)), t(rng.rand(B).astype(np.float32))
    gfull = t(rng.randn(B, C + 8).astype(np.float32))
    gfull[::5] = 0.0
    g = gfull[:, 4:C + 4]
    flat = torch.zeros(4 + R * R, 16, device=cuda)
    from customnerf_torch.ops import kernels
    d0 = kernels.device_launches("plane_dtable")
    got = tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=flat[4:4 + R * R], bf16=True)
    want = tk.plane_dtable_reference(u0, v0, fu, fv, g.contiguous(), R, C, bf16=True)
    f32 = tk.plane_dtable_reference(u0, v0, fu, fv, g.contiguous(), R, C)
    torch.cuda.synchronize()
    d1 = kernels.device_launches("plane_dtable")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (0, 1)
    scale = float(want.abs().max())
    torch.testing.assert_close(got[:, :C], want, rtol=0, atol=1e-5 * scale)
    assert float((got[:, :C] - f32).abs().max()) > 1e-5 * scale
    assert float(flat[:4].abs().max()) == 0.0 and not flat[:, C:].any()


def test_dtable_kernel_all_zero_cotangent_adds_nothing(cuda):
    from customnerf_torch.ops import triplane_kernels as tk
    rng = np.random.RandomState(1)
    u0, v0, fu, fv, g = _dtable_inputs(rng, 4096, 128, 16, cuda)
    out = tk.plane_dtable(u0, v0, fu, fv, torch.zeros_like(g), 128, 16)
    assert not out.any()


def test_triplane_backward_on_card_matches_cpu(cuda):
    from customnerf_torch.ops.triplane import TriplaneSpec, triplane_encode, triplane_init
    # channel widths that are multiples of 4, as the dT kernel needs
    spec = TriplaneSpec(resolutions=(16, 32), channels=(4, 8))
    table = triplane_init(spec, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.rand(777, 3).astype(np.float32))
    g = torch.tensor(rng.randn(777, spec.output_dim).astype(np.float32))

    def grads(dev):
        t = table.to(dev).clone().requires_grad_(True)
        xx = x.to(dev).clone().requires_grad_(True)
        (triplane_encode(xx, t, spec) * g.to(dev)).sum().backward()
        return xx.grad.cpu(), t.grad.cpu()

    dx_c, dt_c = grads("cpu")
    dx_g, dt_g = grads(cuda)
    torch.testing.assert_close(dt_g, dt_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-4, atol=1e-5)


def test_tiny_editing_step_on_card(cuda, tmp_path, monkeypatch):
    """Phase 1 → checkpoint → one LGIE/SDS editing step on the card with a
    tiny SD stack: both kernels launch, the losses are finite, the field
    moves."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.guidance.text import (CLIPTextConfig, CLIPTextModel,
                                                TextEncoder)
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig
    from customnerf_torch.ops import kernels

    field = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 8 "
             "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
             "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
             "--data_type synthetic --h 16 --w 16 --train_size 4 --iters 8 "
             "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
             "--max_steps 32 --ckpt scratch").split()
    recon = Trainer(parse_args(field + ["--workspace", str(tmp_path / "r")]),
                    use_checkpoint="scratch", log=lambda *_: None)
    recon.train(NeRFDataset(recon.opt, "train").dataloader(), max_epochs=2)
    opt = parse_args(field + [
        "--workspace", str(tmp_path / "e"), "--pretrained", "--editing_from",
        str(tmp_path / "r" / "checkpoints" / "df_ep0002.pth"), "--text", "a corgi",
        "--text_fg", "a dog", "--lambda_sd", "0.01", "--keep_bg", "100",
        "--random_bg_c", "--detach_bg", "--stage_time", "--allow_random_guidance"])
    text = TextEncoder(model=build(
        CLIPTextModel, CLIPTextConfig(hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4),
        device=cuda, generator=torch.Generator(device=cuda).manual_seed(0)))
    guidance = StableDiffusionGuidance(
        opt, device=cuda, text_encoder=text,
        unet_cfg=UNetConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            cross_attention_dim=32, attention_head_dim=4,
                            norm_num_groups=8),
        vae_cfg=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                          norm_num_groups=8, sample_size=64))
    tr = Trainer(opt, guidance=guidance, use_checkpoint="scratch", log=lambda *_: None)
    before = [p.detach().clone() for p in tr.field.parameters()]
    batch = NeRFDataset(opt, "train").dataloader().item(0)
    # -O: the bf16 heads and dT's bf16 operands (the JAX package's policy)
    n_mlp = kernels.device_launches("fused_mlp")[1]
    n_dt = kernels.device_launches("plane_dtable")[1]
    loss, aux, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    assert kernels.device_launches("fused_mlp")[1] > n_mlp
    assert kernels.device_launches("plane_dtable")[1] > n_dt
    assert set(aux) == {"loss_sds", "loss_bg"}
    assert all(bool(torch.isfinite(v)) for v in aux.values())
    assert any(bool((p.detach() != b).any()) for p, b in zip(tr.field.parameters(), before))


TINY_UNET = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                 cross_attention_dim=32, attention_head_dim=4, norm_num_groups=8)
TINY_TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4)
# SD 2.x's shapes at reduced width: 64-wide heads at every level (20 heads
# at 1280 channels at full width), a context wider than the 1.5 stack's and
# an exact-GELU text tower
SD2_UNET = dict(block_out_channels=(64, 128, 128, 128), layers_per_block=1,
                cross_attention_dim=64, attention_head_dim=(1, 2, 2, 2), norm_num_groups=8)
SD2_TEXT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, hidden_act="gelu")


def _tiny_guidance(opt, device, seed=0, dtype=None, unet=TINY_UNET, text=TINY_TEXT):
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.guidance.text import (CLIPTextConfig, CLIPTextModel,
                                                TextEncoder)
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig
    text = TextEncoder(model=build(
        CLIPTextModel, CLIPTextConfig(**text),
        device=device, generator=torch.Generator(device=device).manual_seed(seed)))
    return StableDiffusionGuidance(
        opt, device=device, text_encoder=text, unet_cfg=UNetConfig(**unet),
        vae_cfg=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                          norm_num_groups=8, sample_size=64), dtype=dtype)


def _jpeg_concepts(d, n=2, size=48):
    from customnerf_torch.utils.jpeg import write_jpeg
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(0)
    for i in range(n):
        write_jpeg(os.path.join(d, f"v{i}.jpg"), (rs.rand(size, size, 3) * 255).astype(np.uint8))
    return d


@pytest.mark.parametrize("dtype,loss_rel,grad_share", [("float32", 1e-4, 1e-4),
                                                       ("bfloat16", 1e-2, 1e-1)])
def test_tuning_step_on_card_matches_cpu(cuda, tmp_path, monkeypatch, dtype, loss_rel,
                                         grad_share):
    """One Custom Diffusion step (batch 2 with prior) at reduced width on
    the card against the same step on the CPU, the same weights, draws and
    SD dtype: in f32 the loss to 1e-4 relative, and the gradient AdamW is
    handed (adapters and token row) to 1e-4 of each tensor's largest entry
    (cuDNN and cuBLAS sum in other orders, TF32 off in cuBLAS and cuDNN); in
    bf16 (the card's default) the loss to 1e-2 and the gradients to 5e-2,
    the rule of ``tests/test_torch_bf16.py`` (a sum near a bf16 rounding
    boundary lands one ulp apart).  The update itself is not compared entry
    by entry: Adam's first step sends every entry to ±lr, so an entry whose
    gradient is within rounding of zero may go either way."""
    from customnerf_torch.config import Config
    from customnerf_torch.guidance import custom_diffusion as cd
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    opt = Config(data_type="synthetic", seed=0)
    g_cpu, g_card = (_tiny_guidance(opt, "cpu", dtype=dtype),
                     _tiny_guidance(opt, cuda, dtype=dtype))
    for a, b in ((g_cpu.unet, g_card.unet), (g_cpu.vae, g_card.vae),
                 (g_cpu.text_encoder.model, g_card.text_encoder.model)):
        b.load_state_dict(a.state_dict())
    inst = _jpeg_concepts(str(tmp_path / "inst"))
    cls = _jpeg_concepts(str(tmp_path / "cls"), 2, 64)
    gen = torch.Generator().manual_seed(5)
    fixed = [{k: torch.randn(2, 4, 8, 8, generator=gen) for k in ("vae", "noise", "vae2", "noise2")}]
    grads, step = [], torch.optim.AdamW.step

    def spy(self, *a, **k):
        grads.append([p.grad.detach().cpu().clone() for gr in self.param_groups
                      for p in gr["params"]])
        return step(self, *a, **k)

    monkeypatch.setattr(torch.optim.AdamW, "step", spy)
    losses = []
    for name, g in (("cpu", g_cpu), ("card", g_card)):
        cd.train_custom_diffusion(opt, inst, "bear", str(tmp_path / name), class_dir=cls,
                                  class_prompt="bear", steps=1, lr=1e-3, image_size=64,
                                  batch_size=2, checkpointing_steps=0, guidance=g,
                                  draws=lambda i: fixed[i], log=lambda *_: None,
                                  on_step=lambda s, v: losses.append(v))
    assert losses[1] == pytest.approx(losses[0], rel=loss_rel)
    assert len(grads) == 2 and len(grads[0]) == len(grads[1]) == 2 * 10 + 1
    for i, (want, got) in enumerate(zip(*grads)):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert err <= grad_share * scale, (i, tuple(want.shape), err, scale)
    assert float(grads[0][-1].abs().max()) > 0            # the token row's


def test_use_cd_editing_step_on_card(cuda, tmp_path, monkeypatch):
    """JPEG concept images → 2 tuning steps on the card → phase 1 → one
    ``--use_cd`` LGIE/SDS editing step: both kernels launch, the adapters
    change ε, the losses are finite."""
    from customnerf_torch.config import Config, parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance import custom_diffusion as cd
    from customnerf_torch.ops import kernels

    inst = _jpeg_concepts(str(tmp_path / "inst"))
    cd_dir = cd.train_custom_diffusion(
        Config(data_type="synthetic", seed=0), inst, "bear", str(tmp_path / "cd"),
        steps=2, lr=1e-3, image_size=64, batch_size=1, checkpointing_steps=0,
        guidance=_tiny_guidance(Config(data_type="synthetic", seed=0), cuda),
        log=lambda *_: None)
    field = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 8 "
             "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
             "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
             "--data_type synthetic --h 16 --w 16 --train_size 4 --iters 8 "
             "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
             "--max_steps 32 --ckpt scratch").split()
    recon = Trainer(parse_args(field + ["--workspace", str(tmp_path / "r")]),
                    use_checkpoint="scratch", log=lambda *_: None)
    recon.train(NeRFDataset(recon.opt, "train").dataloader(), max_epochs=2)
    opt = parse_args(field + [
        "--workspace", str(tmp_path / "e"), "--pretrained", "--editing_from",
        str(tmp_path / "r" / "checkpoints" / "df_ep0002.pth"), "--text",
        "a <new1> bear in a forest", "--text_fg", "a <new1> bear", "--lambda_sd", "0.01",
        "--keep_bg", "100", "--random_bg_c", "--detach_bg", "--stage_time",
        "--allow_random_guidance", "--use_cd", cd_dir])
    guidance = _tiny_guidance(opt, cuda)
    assert guidance.cd_kv is not None and all(
        v.is_cuda for e in guidance.cd_kv.values() for v in e.values())
    ctx = guidance.get_text_embeds(["a <new1> bear"], [""])
    x = torch.randn(2, 4, 8, 8, device=cuda)
    t = torch.tensor([500, 500], device=cuda)
    with torch.no_grad():
        assert not torch.equal(guidance.unet(x, t, ctx, cd_kv=guidance.cd_kv),
                               guidance.unet(x, t, ctx))
    tr = Trainer(opt, guidance=guidance, use_checkpoint="scratch", log=lambda *_: None)
    batch = NeRFDataset(opt, "train").dataloader().item(0)
    # -O: the bf16 heads and dT's bf16 operands (the JAX package's policy)
    n_mlp = kernels.device_launches("fused_mlp")[1]
    n_dt = kernels.device_launches("plane_dtable")[1]
    loss, aux, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    assert kernels.device_launches("fused_mlp")[1] > n_mlp
    assert kernels.device_launches("plane_dtable")[1] > n_dt
    assert all(bool(torch.isfinite(v)) for v in aux.values())


def test_nerfstudio_fixture_run_on_card(cuda, tmp_path):
    """30 flagship steps on a small nerfstudio fixture (the repo's bear
    scene, 8 views of 200×150, written without cv2): both kernels launch,
    the loss on a fixed view falls, and the evaluation renders are finite
    and write their strip and the best checkpoint."""
    import math
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.data import fixtures
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.ops import kernels

    data = fixtures.write("nerfstudio", str(tmp_path / "data"), 8, 200, 150)
    opt = parse_args(FLAGSHIP_ARGS + [
        "--data_type", "nerfstudio", "--data_path", data, "--keyword", "lang_bear",
        "--train_resolution_level", "2", "--eval_resolution_level", "4",
        "--iters", "30", "--train_size", "15", "--update_extra_interval", "10",
        "--workspace", str(tmp_path / "ws"), "--ckpt", "scratch"])
    tr = Trainer(opt, use_checkpoint="scratch", log=lambda *_: None)
    train = NeRFDataset(opt, "train").dataloader()
    val = NeRFDataset(opt, "val").dataloader()
    fixed = train.item(0)

    @torch.no_grad()
    def fixed_loss():
        out = tr.render(fixed.rays_o, fixed.rays_d, train=True, perturb=False)
        return float(tr.loss(out, fixed.rgbs.reshape(-1, 3), fixed.mask.reshape(-1))[0])

    # -O: the bf16 heads and dT's bf16 operands (the JAX package's policy)
    n_mlp = kernels.device_launches("fused_mlp")[1]
    n_dt = kernels.device_launches("plane_dtable")[1]
    before = fixed_loss()
    tr.train(train, max_epochs=2, valid_loader=val)
    after = fixed_loss()
    torch.cuda.synchronize()
    assert tr.global_step == 30
    assert kernels.device_launches("fused_mlp")[1] > n_mlp
    assert kernels.device_launches("plane_dtable")[1] > n_dt
    assert math.isfinite(after) and after < before, (before, after)
    psnrs = [-r for r in tr.stats["results"]]
    assert len(psnrs) == 2 and all(math.isfinite(p) for p in psnrs)
    out = tr.render_image(val.item(0).rays_o, val.item(0).rays_d)
    assert bool(torch.isfinite(out["image"]).all())
    assert (tmp_path / "ws" / "validation" / "df_ep0002.png").exists()
    assert (tmp_path / "ws" / "checkpoints" / "df.pth").exists()


# ------------------------------------------------- K steps a dispatch (graphs)
TINY_FIELD = ("--grid_type triplane --triplane_res 8 16 --triplane_channels 4 8 "
              "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
              "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
              "--data_type synthetic --h 16 --w 16 --train_size 4 --iters 8 "
              "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
              "--max_steps 32 --ckpt scratch").split()
TINY_GRID = ("--grid_levels 4 --grid_base_resolution 4 --log2_hashmap_size 10 "
             "--desired_resolution 64 --num_steps 8 --upsample_steps 8 "
             "--bound 2 --train_conf 0.01 --soft_mask --data_type synthetic "
             "--h 16 --w 16 --train_size 4 --iters 8 --max_ray_batch 1000 "
             "--ckpt scratch").split()
GRAPH_CASES = {"O": ["-O"] + TINY_FIELD, "O2": ["-O2"] + TINY_GRID,
               "O_batch_rays": ["-O", "--batch_rays", "128"] + TINY_FIELD}


def _tiny_trainer(flags, tmp, **kw):
    from customnerf_torch.config import parse_args
    from customnerf_torch.engine.trainer import Trainer
    return Trainer(parse_args(flags + ["--workspace", str(tmp)]),
                   use_checkpoint="scratch", log=lambda *_: None, **kw)


def _close_steps(eager, again, graphed, losses_a, losses_b, lr):
    """The graphed run against the eager one: per-step losses within 1e-3
    relative, every parameter within 2·n·lr_g of the eager run's and within
    1e-2·lr_g a step in RMS (a second eager run's distance rides along in
    the message).  The runs take the same draws; they differ by the order
    of the card's atomic sums (dT, ``index_add_``), which Adam's ±lr first
    steps turn into sign flips where a gradient is near zero; a step taken
    wrong moves parameters by ~lr a step (``--iters 8``: the lr falls 10×
    over the run)."""
    n = len(losses_a)
    assert torch.allclose(losses_a, losses_b, rtol=1e-3, atol=0), (losses_a, losses_b)
    for (name, a), c, b in zip(eager.field.named_parameters(), again.field.parameters(),
                               graphed.field.parameters()):
        lr_g = lr * (10.0 if name == "grid_table" else 1.0)
        d, spread = a.detach() - b.detach(), a.detach() - c.detach()
        assert float(d.abs().max()) <= 2 * n * lr_g, name
        rms, floor = float(d.pow(2).mean().sqrt()), float(spread.pow(2).mean().sqrt())
        assert rms <= 1e-2 * lr_g * n, (name, rms, floor)


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_dispatch_matches_eager_steps(cuda, tmp_path, case):
    """Two dispatches of K = 3 (one captured step, replayed) against six
    eager ``train_step`` calls from the same seed (and a second eager run,
    the measure of the card's run-to-run spread): the same draws, the same
    steps."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.dispatch import StepGraph
    flags = GRAPH_CASES[case]
    eager, again, graphed = (_tiny_trainer(flags, tmp_path / d) for d in "abc")
    loader = NeRFDataset(eager.opt, "train").dataloader()
    batches = [loader.item(i % len(loader)) for i in range(6)]
    la = torch.stack([eager.train_step(b)[0] for b in batches])
    for b in batches:
        again.train_step(b)
    lb = torch.cat([graphed.train_many(batches[:3])[0], graphed.train_many(batches[3:])[0]])
    torch.cuda.synchronize()
    assert isinstance(graphed._graphs["recon"][1], StepGraph)
    assert graphed.n_updates == eager.n_updates == 6
    _close_steps(eager, again, graphed, la, lb, eager.opt.lr)


def test_graphed_editing_matches_eager_steps(cuda, tmp_path, monkeypatch):
    """Editing with a tiny SD stack: one dispatch of K = 3 against three
    eager editing steps, from the same checkpoint, seed and stack."""
    _graphed_editing_check(cuda, tmp_path, monkeypatch)


def test_graphed_sd2_editing_matches_eager_steps(cuda, tmp_path, monkeypatch):
    """The same under ``--sd_version 2.1`` with SD 2.x's shapes at reduced
    width (64-wide heads at every level, exact-GELU text), in the card's
    bf16: the 2.x step captures and replays as the eager steps run."""
    _graphed_editing_check(cuda, tmp_path, monkeypatch, ["--sd_version", "2.1"],
                           unet=SD2_UNET, text=SD2_TEXT)


def _graphed_editing_check(cuda, tmp_path, monkeypatch, flags=(), **stack):
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    recon = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path / "r")
    recon.train(NeRFDataset(recon.opt, "train").dataloader(), max_epochs=2)
    opt = parse_args(["-O"] + TINY_FIELD + [
        "--workspace", str(tmp_path / "e"), "--pretrained", "--editing_from",
        str(tmp_path / "r" / "checkpoints" / "df_ep0002.pth"), "--text", "a corgi",
        "--text_fg", "a dog", "--lambda_sd", "0.01", "--keep_bg", "100",
        "--random_bg_c", "--detach_bg", "--stage_time", "--allow_random_guidance",
        *flags])
    guidance = _tiny_guidance(opt, cuda, **stack)
    assert guidance.dtype == "bfloat16"
    eager, again, graphed = (Trainer(opt, guidance=guidance, use_checkpoint="scratch",
                                     log=lambda *_: None) for _ in range(3))
    loader = NeRFDataset(opt, "train").dataloader()
    batches = [loader.item(i % len(loader)) for i in range(3)]
    la = []
    for tr in (eager, again):
        for b in batches:
            tr.global_step += 1
            loss = tr.train_step(b)[0]
            if tr is eager:
                la.append(loss)
    lb, aux = editing.editing_steps_many(graphed, batches)
    torch.cuda.synchronize()
    assert graphed.global_step == 3 and set(aux) == {"loss_sds", "loss_bg"}
    assert "edit" in graphed._graphs
    _close_steps(eager, again, graphed, torch.stack(la), lb, opt.lr)


def test_graph_replays_draw_fresh_jitter(cuda, tmp_path):
    """At lr 0 the field stays put, so two replays on one batch differ only
    by their draws: they must differ (the generator is registered with the
    graph, each replay advancing it)."""
    from customnerf_torch.data.base import NeRFDataset
    tr = _tiny_trainer(["-O", "--lr", "0"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    losses, _ = tr.train_many([b, b, b])
    torch.cuda.synchronize()
    assert len(set(losses.tolist())) == 3, losses


def test_failed_capture_raises_and_never_runs_eager(cuda, tmp_path, monkeypatch):
    """A step that copies a host list to the card (a sync) cannot be
    captured: ``train_many`` raises naming the port's line, and the trainer
    is left as it was (no eager fallback)."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.dispatch import CaptureError
    from customnerf_torch.models import renderer
    tr = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    before = [p.detach().clone() for p in tr.field.parameters()]
    gen = tr.generator.get_state()
    monkeypatch.setattr(renderer, "scene_aabb", lambda bound, device: torch.tensor(
        [-bound] * 3 + [bound] * 3, device=device))
    with pytest.raises(CaptureError, match=r"renderer\.py:\d+ in render_rays_fast"):
        tr.train_many([b, b])
    assert tr.n_updates == 0 and tr.global_step == 0 and "recon" not in tr._graphs
    assert torch.equal(tr.generator.get_state(), gen)
    assert all(torch.equal(p, q) for p, q in zip(tr.field.parameters(), before))
    assert all(float(s["step"]) == 0 for s in tr.optimizer.state.values())


def test_launch_counters_count_replays(cuda, tmp_path):
    """The kernels count their own launches on the card: an eager step's,
    the warm-up steps' of a dispatch and a replay's (which runs no wrapper),
    not the capture's (which launches nothing)."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.dispatch import WARMUP_STEPS
    from customnerf_torch.ops import kernels

    def device():
        return (kernels.device_launches("fused_mlp")[1],
                kernels.device_launches("plane_dtable")[1])

    def since(now, then):
        return tuple(x - y for x, y in zip(now, then))

    tr = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    d0 = device()
    tr.train_step(b)
    one = since(device(), d0)
    assert all(n > 0 for n in one)
    d1 = device()
    tr.train_many([b])                       # warm-up (eager steps), capture, 1 replay
    assert since(device(), d1) == tuple((WARMUP_STEPS + 1) * n for n in one)
    d2 = device()
    tr.train_many([b] * 4)                   # replays only
    assert since(device(), d2) == tuple(4 * n for n in one)


def test_device_lr_follows_the_schedule(cuda, tmp_path):
    """On the card the decayed lr is computed on the device from the update
    counter (a captured step replays it): after eager steps, after replays,
    and after a resume (``_bind_optimizer``), each group's lr is the f32 of
    lr_scale · lr_at(the update just taken), over a schedule short enough
    (``--iters 8``) that a frozen or stale lr would differ."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer

    def check(tr):
        torch.cuda.synchronize()
        base = tr.lr_at(tr.n_updates - 1)
        for group in tr.optimizer.param_groups:      # the lr Adam reads
            lr = group["lr"]
            assert torch.is_tensor(lr) and lr.is_cuda
            want = torch.tensor(group["lr_scale"] * base, dtype=torch.float32)
            assert torch.equal(lr.cpu(), want), (tr.n_updates, float(lr), float(want))

    tr = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path / "a")
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    lrs = []
    for _ in range(3):
        tr.train_step(b)
        check(tr)
        lrs.append(float(tr.optimizer.param_groups[1]["lr"]))
    for k in (1, 2):
        tr.train_many([b] * k)
        check(tr)
        lrs.append(float(tr.optimizer.param_groups[1]["lr"]))
    assert tr.n_updates == 6 and len(set(lrs)) == len(lrs) == 5   # it moves
    path = tr.save_checkpoint()
    back = Trainer(tr.opt, use_checkpoint=path, log=lambda *_: None)
    assert back.n_updates == 6
    back.train_many([b] * 2)
    check(back)
    back.train_step(b)
    check(back)
    assert back.n_updates == 9


def test_async_checkpoint_reloads_bitwise_on_card(cuda, tmp_path):
    """``--ckpt_format orbax`` on the card: a save's ``.orbax`` directory,
    written while replays went on updating the state in place, reloads bit
    for bit as the state at the save."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import checkpoint as ckpt_io
    from customnerf_torch.engine.convert import params_from_flax
    tr = _tiny_trainer(["-O", "--ckpt_format", "orbax"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    tr.train_many([b] * 3)
    want = {k: v.detach().cpu().clone() for k, v in tr.field.state_dict().items()}
    adam = {k: v.detach().cpu().clone()
            for k, v in tr.optimizer.state[tr.field.grid_table].items()}
    path = tr.save_checkpoint()
    tr.train_many([b] * 3)
    tr.wait_for_saves()
    assert path.endswith(".orbax")
    params, meta = ckpt_io.load_checkpoint(path, layout=tr.optax_layout())
    got = params_from_flax(params)
    assert all(torch.equal(got[k], want[k]) for k in want)
    saved = meta[ckpt_io.TORCH_OPTIMIZER_KEY]["adam"]
    assert float(saved["step"]) == float(adam["step"]) == 3
    assert all(torch.equal(saved[k]["grid_table"], adam[k])
               for k in ("exp_avg", "exp_avg_sq"))
    assert not torch.equal(tr.field.grid_table.detach().cpu(), want["grid_table"])


# ------------------------------------------- the tracer's stamps (spans.cu)
@pytest.fixture
def tracer_off_after():
    from customnerf_torch.engine import spans
    yield spans
    spans.enable(False)
    spans.reset()


def test_span_stamps_replay_with_the_graph_in_order(cuda, tmp_path, tracer_off_after):
    """A step captured with the tracer on holds its stamps as graph nodes:
    the warm-up steps stamp as an eager step does, the capture stamps
    nothing, and each of K replays appends the eager step's stamps again,
    in order, on the card's clock."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.dispatch import WARMUP_STEPS
    spans = tracer_off_after
    tr = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    spans.enable(True, "cuda")
    spans.reset()
    tr.train_step(b)
    one = [tag for tag, _ in spans._card_stamps()[0]]
    assert one and one[0] == 2 * spans._id("recon.step")
    spans.reset()
    tr.train_many([b])                       # warm-up steps, capture, one replay
    assert [tag for tag, _ in spans._card_stamps()[0]] == one * (WARMUP_STEPS + 1)
    spans.reset()
    tr.train_many([b] * 4)                   # replays only
    stamps, dropped = spans._card_stamps()
    assert [tag for tag, _ in stamps] == one * 4 and dropped == 0
    times = [t for _, t in stamps]
    assert times == sorted(times)
    got = spans.collect()["spans"]
    assert got["recon.step"]["count"] == 4 and got["k1.bwd"]["count"] == 4
    assert 0 <= got["recon.step"]["self_ms"] < got["recon.step"]["device_ms"]


def test_span_ring_full_counts_drops_and_does_not_wrap(cuda, tracer_off_after):
    """Past the ring's capacity a stamp writes nothing and is counted as
    dropped; the first stamps stay where they were."""
    from customnerf_torch.ops import kernels
    spans = tracer_off_after
    spans.enable(True, "cuda")
    spans.reset()
    cap = int(kernels.library().cn_span_capacity())
    assert cap == spans.CAPACITY
    for _ in range(cap // 2 + 5):
        spans.begin("s")
        spans.end("s")
    stamps, dropped = spans._card_stamps()
    i = spans._id("s")
    assert len(stamps) == cap and dropped == 10
    assert [tag for tag, _ in stamps] == [2 * i, 2 * i + 1] * (cap // 2)
    assert spans.collect()["counters"]["dropped_stamps"] == 10


def test_switching_the_tracer_captures_again(cuda, tmp_path, tracer_off_after):
    """The tracer is part of the graph key: switching it on or off captures
    the step again (counted), and a graph captured with it off stamps
    nothing when replayed."""
    from customnerf_torch.data.base import NeRFDataset
    spans = tracer_off_after
    tr = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    captures = spans.counters["capture"]
    tr.train_many([b])
    g0 = tr._graphs["recon"][1]
    spans.enable(True, "cuda")
    spans.reset()
    tr.train_many([b])
    g1 = tr._graphs["recon"][1]
    assert g1 is not g0 and spans._card_stamps()[0]
    spans.enable(False)
    tr.train_many([b])
    assert tr._graphs["recon"][1] is not g1
    spans.reset()
    tr.train_many([b] * 3)                   # the tracer-off graph, replayed
    assert spans._card_stamps() == ([], 0)
    assert spans.counters["capture"] - captures == 3
    assert spans.counters["capture_s"] > 0


def test_tracer_on_and_off_take_bit_identical_graphed_steps(cuda, tmp_path,
                                                            tracer_off_after):
    """Two dispatches of K = 3 from one seed, the tracer off and on: the
    same losses bit for bit.  At lr 0 the field stays put, so the losses are
    the forward's alone, which has no atomics (a training step's atomic sums
    would differ run to run whatever the tracer does)."""
    from customnerf_torch.data.base import NeRFDataset
    spans = tracer_off_after
    flags = ["-O", "--lr", "0"] + TINY_FIELD
    losses = []
    for on in (False, True):
        spans.enable(on, "cuda")
        tr = _tiny_trainer(flags, tmp_path / str(on))
        loader = NeRFDataset(tr.opt, "train").dataloader()
        batches = [loader.item(i % len(loader)) for i in range(6)]
        losses.append(torch.cat([tr.train_many(batches[:3])[0],
                                 tr.train_many(batches[3:])[0]]).cpu())
    assert torch.equal(losses[0], losses[1]), losses
    assert len(set(losses[0].tolist())) == 6


def test_graphed_editing_step_splits_its_backward(cuda, tmp_path, monkeypatch,
                                                  tracer_off_after):
    """The editing step captured with the tracer on: the gradient hooks ran
    during the capture, so each replay stamps the VAE's, the resize's and
    the render's backward inside ``backward``, and every stage of
    ``edit.step`` once a step."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    spans = tracer_off_after
    recon = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path / "r")
    recon.train(NeRFDataset(recon.opt, "train").dataloader(), max_epochs=1)
    opt = parse_args(["-O"] + TINY_FIELD + [
        "--workspace", str(tmp_path / "e"), "--pretrained", "--editing_from",
        str(tmp_path / "r" / "checkpoints" / "df_ep0001.pth"), "--text", "a corgi",
        "--text_fg", "a dog", "--lambda_sd", "0.01", "--keep_bg", "100",
        "--random_bg_c", "--detach_bg", "--allow_random_guidance"])
    tr = Trainer(opt, guidance=_tiny_guidance(opt, cuda), use_checkpoint="scratch",
                 log=lambda *_: None)
    loader = NeRFDataset(opt, "train").dataloader()
    batches = [loader.item(i % len(loader)) for i in range(3)]
    spans.enable(True, "cuda")
    editing.editing_steps_many(tr, batches)          # pt renders, capture, replays
    spans.reset()
    editing.editing_steps_many(tr, batches)          # replays only
    stamps, _ = spans._card_stamps()
    got = spans.collect()["spans"]
    stages = ("edit.step", "render", "resize", "vae_encode", "unet", "loss", "backward",
              "vae_encode.bwd", "resize.bwd", "render.bwd", "k1.bwd", "adam")
    assert all(got[n]["count"] == 3 for n in stages), got
    depth = {spans._names[i]: d for i, _, _, d, _ in spans.occurrences(stamps)}
    assert depth["backward"] == 1 and depth["render.bwd"] == 2 and depth["k1.bwd"] == 3
    kids = ("render", "resize", "vae_encode", "unet", "loss", "backward", "adam")
    step = got["edit.step"]
    assert step["self_ms"] + sum(got[n]["device_ms"] for n in kids) == pytest.approx(
        step["device_ms"], rel=1e-9)
    assert got["pre_pass"]["host_count"] == 3 and got["replay"]["host_count"] == 3
