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
