"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (ragged tails, strided views, an end-to-end encode backward).

Marked ``cuda``: they need a CUDA device and nvcc, and skip elsewhere.  Run
them on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (that
machine has no JAX, which ``tests/conftest.py`` imports).
"""

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


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_grid_encode_on_card_matches_cpu(cuda, gridtype):
    """The plain grid encoder on the card against the same call on the CPU:
    the output, and the table gradient summed by index_add_ atomics."""
    from customnerf_torch.ops.grid import GridSpec, grid_encode
    spec = GridSpec(num_levels=16, level_dim=2, base_resolution=16,
                    log2_hashmap_size=15, desired_resolution=1024, gridtype=gridtype)
    table = torch.rand(spec.table_size, spec.level_dim,
                       generator=torch.Generator().manual_seed(0)) * 2.0 - 1.0
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.rand(20000, 3).astype(np.float32) * 1.1 - 0.05)
    g = torch.tensor(rng.randn(20000, spec.output_dim).astype(np.float32))

    def run(dev):
        t = table.to(dev).clone().requires_grad_(True)
        xx = x.to(dev).clone().requires_grad_(True)
        out = grid_encode(xx, t, spec)
        (out * g.to(dev)).sum().backward()
        return out.detach().cpu(), t.grad.cpu(), xx.grad.cpu()

    for got, want in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


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
    n_mlp, n_dt = fused_mlp.fused_mlp_forward.launches, triplane_kernels.plane_dtable.launches
    loss, aux, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_forward.launches > n_mlp
    assert triplane_kernels.plane_dtable.launches > n_dt
    assert set(aux) == {"loss_sds", "loss_bg"}
    assert all(bool(torch.isfinite(v)) for v in aux.values())
    assert any(bool((p.detach() != b).any()) for p, b in zip(tr.field.parameters(), before))


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

    n_mlp, n_dt = fused_mlp.fused_mlp_forward.launches, triplane_kernels.plane_dtable.launches
    before = fixed_loss()
    tr.train(train, max_epochs=2, valid_loader=val)
    after = fixed_loss()
    torch.cuda.synchronize()
    assert tr.global_step == 30
    assert fused_mlp.fused_mlp_forward.launches > n_mlp
    assert triplane_kernels.plane_dtable.launches > n_dt
    assert math.isfinite(after) and after < before, (before, after)
    psnrs = [-r for r in tr.stats["results"]]
    assert len(psnrs) == 2 and all(math.isfinite(p) for p in psnrs)
    out = tr.render_image(val.item(0).rays_o, val.item(0).rays_d)
    assert bool(torch.isfinite(out["image"]).all())
    assert (tmp_path / "ws" / "validation" / "df_ep0002.png").exists()
    assert (tmp_path / "ws" / "checkpoints" / "df.pth").exists()
