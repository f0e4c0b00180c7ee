"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (ragged tails, strided views, an end-to-end encode backward).

Marked ``cuda``: they need a CUDA device and nvcc, and skip elsewhere.  Run
them on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (that
machine has no JAX, which ``tests/conftest.py`` imports).
"""

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
    x, v, ws = _mlp_problem(B, cuda, B)
    n0 = fm.fused_mlp_forward.launches
    sk, rk = fm.fused_mlp_forward(x, v, ws, with_rgb=with_rgb)
    sp, rp = fm.reference_forward(x, v, ws, with_rgb=with_rgb)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == n0 + 1
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
    rng = np.random.RandomState(B)
    shapes = [(32, 64)] + SHAPES[1:]
    ws = [torch.tensor((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
                       device=cuda) for s in shapes]
    x = torch.tensor(rng.randn(B, 32).astype(np.float32), device=cuda)
    v = torch.tensor(rng.randn(B, 27).astype(np.float32), device=cuda)
    n0 = fm.fused_mlp_forward.launches
    sk, rk = fm.fused_mlp_forward(x, v, ws, with_rgb=with_rgb)
    sp, rp = fm.reference_forward(x, v, ws, with_rgb=with_rgb)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == n0 + 1
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
    n0, n32 = fm.fused_mlp_forward.launches_bf16, fm.fused_mlp_forward.launches
    d0 = kernels.device_launches("fused_mlp")
    sk, rk = fm.fused_mlp_forward(x, v, ws, with_rgb=with_rgb, bf16=True)
    sp, rp = fm.reference_forward(x, v, ws, with_rgb=with_rgb, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches_bf16 == n0 + 1
    assert fm.fused_mlp_forward.launches == n32
    d1 = kernels.device_launches("fused_mlp")      # the kernel's own count
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
    the wrapper's and the card's launch counts equal.  Tolerance: forward
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

    n0 = (grid_encode.launches, grid_encode.launches_bwd)
    d0 = kernels.device_launches("grid_encode")
    card = run(cuda)
    d1 = kernels.device_launches("grid_encode")
    n1 = (grid_encode.launches, grid_encode.launches_bwd)
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (1, 1)
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
    n0 = (grid_encode.launches, grid_encode.launches_bwd)
    d0 = kernels.device_launches("grid_encode")
    graph.replay()
    d1 = kernels.device_launches("grid_encode")
    assert (d1[0] - d0[0], d1[1] - d0[1]) == (1, 1)
    assert (grid_encode.launches, grid_encode.launches_bwd) == n0
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
    n0, n32 = tk.plane_dtable.launches_bf16, tk.plane_dtable.launches
    d0 = kernels.device_launches("plane_dtable")
    got = tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=flat[4:4 + R * R], bf16=True)
    want = tk.plane_dtable_reference(u0, v0, fu, fv, g.contiguous(), R, C, bf16=True)
    f32 = tk.plane_dtable_reference(u0, v0, fu, fv, g.contiguous(), R, C)
    torch.cuda.synchronize()
    assert tk.plane_dtable.launches_bf16 == n0 + 1 and tk.plane_dtable.launches == n32
    d1 = kernels.device_launches("plane_dtable")   # the kernel's own count
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
    from customnerf_torch.ops import fused_mlp, triplane_kernels

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
                          norm_num_groups=8))
    tr = Trainer(opt, guidance=guidance, use_checkpoint="scratch", log=lambda *_: None)
    monkeypatch.setattr(editing, "RESIZE", 64)
    before = [p.detach().clone() for p in tr.field.parameters()]
    batch = NeRFDataset(opt, "train").dataloader().item(0)
    # -O: the bf16 heads and dT's bf16 operands (the JAX package's policy)
    n_mlp = fused_mlp.fused_mlp_forward.launches_bf16
    n_dt = triplane_kernels.plane_dtable.launches_bf16
    loss, aux, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches_bf16 > n_mlp
    assert triplane_kernels.plane_dtable.launches_bf16 > n_dt
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
                          norm_num_groups=8), dtype=dtype)


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
    from customnerf_torch.ops import fused_mlp, triplane_kernels

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
    monkeypatch.setattr(editing, "RESIZE", 64)
    batch = NeRFDataset(opt, "train").dataloader().item(0)
    # -O: the bf16 heads and dT's bf16 operands (the JAX package's policy)
    n_mlp = fused_mlp.fused_mlp_forward.launches_bf16
    n_dt = triplane_kernels.plane_dtable.launches_bf16
    loss, aux, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches_bf16 > n_mlp
    assert triplane_kernels.plane_dtable.launches_bf16 > n_dt
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
    from customnerf_torch.ops import fused_mlp, triplane_kernels

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
    n_mlp = fused_mlp.fused_mlp_forward.launches_bf16
    n_dt = triplane_kernels.plane_dtable.launches_bf16
    before = fixed_loss()
    tr.train(train, max_epochs=2, valid_loader=val)
    after = fixed_loss()
    torch.cuda.synchronize()
    assert tr.global_step == 30
    assert fused_mlp.fused_mlp_forward.launches_bf16 > n_mlp
    assert triplane_kernels.plane_dtable.launches_bf16 > n_dt
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
    monkeypatch.setattr(editing, "RESIZE", 64)
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
    """The kernels count their own launches on the card, a replay's
    included; the wrappers count the warm-up steps' launches, not the
    capture's (which launches nothing) and not a replay's (which runs no
    wrapper)."""
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.dispatch import WARMUP_STEPS
    from customnerf_torch.ops import fused_mlp, kernels, triplane_kernels

    def wrappers():
        return (fused_mlp.fused_mlp_forward.launches_bf16,
                triplane_kernels.plane_dtable.launches_bf16)

    def device():
        return (kernels.device_launches("fused_mlp")[1],
                kernels.device_launches("plane_dtable")[1])

    def since(now, then):
        return tuple(x - y for x, y in zip(now, then))

    tr = _tiny_trainer(["-O"] + TINY_FIELD, tmp_path)
    b = NeRFDataset(tr.opt, "train").dataloader().item(0)
    w0, d0 = wrappers(), device()
    tr.train_step(b)
    one = since(wrappers(), w0)
    assert all(n > 0 for n in one) and since(device(), d0) == one
    w1, d1 = wrappers(), device()
    tr.train_many([b])                       # warm-up (eager steps), capture, 1 replay
    assert since(wrappers(), w1) == tuple(WARMUP_STEPS * n for n in one)
    assert since(device(), d1) == tuple((WARMUP_STEPS + 1) * n for n in one)
    w2, d2 = wrappers(), device()
    tr.train_many([b] * 4)                   # replays only
    assert since(wrappers(), w2) == (0, 0)
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
    monkeypatch.setattr(editing, "RESIZE", 64)
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
