"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (ragged tails, strided views, an end-to-end encode backward).

Marked ``cuda``: they need a CUDA device and nvcc, and skip elsewhere.  Run
them on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 383, 384, 385, 5000])
def test_fused_mlp_kernel_matches_plain(cuda, B):
    from customnerf_torch.ops import fused_mlp as fm
    rng = np.random.RandomState(B)
    shapes = [(72, 64), (64, 64), (64, 64), (64, 64), (64, 1), (91, 64), (64, 4)]
    ws = [torch.tensor((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
                       device=cuda) for s in shapes]
    x = torch.tensor(rng.randn(B, 72).astype(np.float32), device=cuda)
    v = torch.tensor(rng.randn(B, 27).astype(np.float32), device=cuda)
    n0 = fm.fused_mlp_forward.launches
    sk, rk = fm.fused_mlp_forward(x, v, ws)
    sp, rp = fm.reference_forward(x, v, ws)
    torch.cuda.synchronize()
    assert fm.fused_mlp_forward.launches == n0 + 1
    # f32 vs f32, another summation order: ≤ 1e-4 of O(1) outputs
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("R,C", [(16, 4), (128, 16), (512, 8)])
def test_dtable_kernel_matches_plain_into_view(cuda, R, C):
    from customnerf_torch.ops import triplane_kernels as tk
    rng = np.random.RandomState(R + C)
    B = 3001
    u0 = torch.tensor(rng.randint(0, R - 1, B).astype(np.int32), device=cuda)
    v0 = torch.tensor(rng.randint(0, R - 1, B).astype(np.int32), device=cuda)
    fu = torch.tensor(rng.rand(B).astype(np.float32), device=cuda)
    fv = torch.tensor(rng.rand(B).astype(np.float32), device=cuda)
    gfull = torch.tensor(rng.randn(B, C + 3).astype(np.float32), device=cuda)
    gfull[::3] = 0.0          # dead compaction slots: the kernel skips them
    u0[::3] = v0[::3] = R // 2
    g = gfull[:, 1:C + 1]                       # strided column slice
    flat = torch.zeros(5 + R * R, 16, device=cuda)
    got = tk.plane_dtable(u0, v0, fu, fv, g, R, C, out=flat[5:5 + R * R])
    want = tk.plane_dtable_reference(u0, v0, fu, fv, g.contiguous(), R, C)
    torch.cuda.synchronize()
    # atomics sum in a varying order: a few ulp of the row sums
    torch.testing.assert_close(got[:, :C], want, rtol=1e-5, atol=1e-5)
    assert float(flat[:5].abs().max()) == 0.0
    assert not flat[:, C:].any()


def test_triplane_backward_on_card_matches_cpu(cuda):
    from customnerf_torch.ops.triplane import TriplaneSpec, triplane_encode, triplane_init
    spec = TriplaneSpec(resolutions=(16, 32), channels=(4, 2))
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
