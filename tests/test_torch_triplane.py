"""Tri-plane encode and its table gradient: the PyTorch port against the JAX
package, on the CPU.

The JAX side runs ``triplane_encode`` with the scatter-free matmul backward
in f32 (``bwd="matmul", mm_bf16=False``) and the NumPy oracle
``triplane_encode_reference``; the port's dT plain version is also held
against ``_plane_dtable`` and both Pallas dT kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.ops import triplane as jtri
from customnerf_tpu.ops.triplane_pallas import (plane_dtable_pallas,
                                                plane_dtable_pallas_fw)
from customnerf_torch.ops import triplane, triplane_kernels

RES, CH = (8, 16), (4, 2)


def _specs(res=RES, ch=CH):
    jspec = jtri.TriplaneSpec(resolutions=res, channels=ch, bwd="matmul",
                              mm_bf16=False, bwd_chunk=64)
    return jspec, triplane.TriplaneSpec(resolutions=res, channels=ch)


def _points(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3).astype(np.float32)
    edge = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 1.0, 0.0],
                     [1.0, 0.25, 1.0],                   # far border
                     [-0.1, 0.5, 0.5], [0.5, 0.5, 1.2]],  # out of range
                    np.float32)
    return np.concatenate([x, edge])


def _table(spec, seed):
    rng = np.random.RandomState(seed)
    # O(1) entries (not the 1e-4 init) so the comparison sees real values
    return rng.randn(spec.table_size, spec.max_channels).astype(np.float32)


def test_spec_layout_matches():
    jspec, tspec = _specs((128, 512), (16, 8))
    assert tspec.output_dim == jspec.output_dim == 72
    assert tspec.table_size == jspec.table_size == 835_584
    np.testing.assert_array_equal(tspec.plane_offsets, jspec.plane_offsets)
    assert [tspec.channels_at(i) for i in range(2)] == [16, 8]


def test_init_range_and_shape():
    _, tspec = _specs()
    t = triplane.triplane_init(tspec, generator=torch.Generator().manual_seed(0))
    assert t.shape == (tspec.table_size, tspec.max_channels)
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5


def test_corner_data_matches_jax():
    jspec, tspec = _specs()
    x = _points(200, 0)
    want = jtri._corner_data(jnp.asarray(x), jspec)
    got = triplane.corner_data(torch.tensor(x), tspec)
    assert len(got) == len(want) == 6
    for (u0, v0, fu, fv, ab, R, C, base), (idx, _w, jfu, jfv, ju0, jv0, jab,
                                           jR) in zip(got, want):
        assert (ab, R) == (jab, jR)
        np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
        np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
        np.testing.assert_array_equal(fu.numpy(), np.asarray(jfu))
        np.testing.assert_array_equal(fv.numpy(), np.asarray(jfv))
        np.testing.assert_array_equal(
            base + u0.numpy().astype(np.int64) * R + v0.numpy(),
            np.asarray(idx)[:, 0])


@pytest.mark.parametrize("res,ch", [(RES, CH), ((16,), 4)])
def test_encode_forward_matches_jax_and_oracle(res, ch):
    jspec, tspec = _specs(res, ch)
    x, table = _points(300, 1), _table(tspec, 2)
    want = np.asarray(jtri.triplane_encode(jnp.asarray(x), jnp.asarray(table),
                                           jspec))
    oracle = jtri.triplane_encode_reference(x, table, jspec)
    got = triplane.triplane_encode(torch.tensor(x), torch.tensor(table),
                                   tspec).numpy()
    # f32 bilinear sums of 4 terms with |T| ≲ 4 summed in another order:
    # a few ulp of 4 (ulp 4.8e-7) where the sum cancels towards zero
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=5e-6)
    np.testing.assert_array_equal(got[-2:], 0.0)   # out of range → zeros


def test_encode_gradients_match_jax_matmul_backward():
    jspec, tspec = _specs()
    x, table = _points(500, 3), _table(tspec, 4)
    g = np.random.RandomState(5).randn(x.shape[0], tspec.output_dim).astype(
        np.float32)

    def jloss(xx, tt):
        return jnp.sum(jtri.triplane_encode(xx, tt, jspec) * g)

    jdx, jdt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(table))
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    (triplane.triplane_encode(xt, tt, tspec) * torch.tensor(g)).sum().backward()
    # dT: sums of ≤ a few hundred f32 products in another order; dx: 6 plane
    # terms scaled by R−1 ≤ 15
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jdt), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-4)
    # narrow level: columns past channels_at(1) get no gradient
    off = int(tspec.plane_offsets[1, 0])
    assert float(tt.grad[off:, CH[1]:].abs().max()) == 0.0
    # out-of-range points: no input gradient
    assert float(xt.grad[-2:].abs().max()) == 0.0


def _dtable_inputs(R, C, B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, R - 1, B).astype(np.int32),
            rng.randint(0, R - 1, B).astype(np.int32),
            rng.rand(B).astype(np.float32), rng.rand(B).astype(np.float32),
            rng.randn(B, C).astype(np.float32))


@pytest.mark.parametrize("R,C", [(8, 4), (16, 4), (16, 2)])
def test_dtable_plain_matches_xla_twin(R, C):
    u0, v0, fu, fv, g = _dtable_inputs(R, C, 1000, R + C)
    want = np.asarray(jtri._plane_dtable(*map(jnp.asarray, (u0, v0, fu, fv, g)),
                                         R, C, chunk=128, use_bf16=False))
    got = triplane_kernels.plane_dtable(*map(torch.tensor, (u0, v0, fu, fv, g)),
                                        R, C).numpy()
    # same sums in another order: ≲ 1e-6 of the row sums (≈ 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pallas", [plane_dtable_pallas, plane_dtable_pallas_fw],
                         ids=["pallas", "pallas_fw"])
def test_dtable_plain_matches_pallas_interpret(pallas):
    R, C = 16, 4
    u0, v0, fu, fv, g = _dtable_inputs(R, C, 100, 7)
    want = np.asarray(pallas(*map(jnp.asarray, (u0, v0, fu, fv, g)), R, C,
                             chunk=32, use_bf16=False, interpret=True))
    got = triplane_kernels.plane_dtable(*map(torch.tensor, (u0, v0, fu, fv, g)),
                                        R, C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dtable_accumulates_into_table_view():
    R, C = 8, 2
    u0, v0, fu, fv, g = _dtable_inputs(R, C + 2, 300, 9)
    gt = torch.tensor(g)[:, 1:C + 1]                      # strided column slice
    flat = torch.zeros(3 + R * R, 4)
    n0 = triplane_kernels.plane_dtable.launches
    triplane_kernels.plane_dtable(*map(torch.tensor, (u0, v0, fu, fv)), gt, R, C,
                                  out=flat[3:3 + R * R])
    want = triplane_kernels.plane_dtable_reference(
        *map(torch.tensor, (u0, v0, fu, fv)), gt.contiguous(), R, C)
    torch.testing.assert_close(flat[3:, :C], want, rtol=0, atol=0)
    assert float(flat[:3].abs().max()) == 0.0 and float(flat[:, C:].abs().max()) == 0.0
    # the plain version on the CPU is not a kernel launch
    assert triplane_kernels.plane_dtable.launches == n0


def test_dtable_wrapper_rejects_bad_inputs():
    R, C = 8, 2
    u0, v0, fu, fv, g = map(torch.tensor, _dtable_inputs(R, C, 10, 1))
    with pytest.raises(TypeError):
        triplane_kernels.plane_dtable(u0.long(), v0, fu, fv, g, R, C)
    with pytest.raises(ValueError):
        triplane_kernels.plane_dtable(u0, v0, fu, fv, g[:5], R, C)
    with pytest.raises(ValueError):
        triplane_kernels.plane_dtable(u0, v0, fu, fv, g, R, C,
                                      out=torch.zeros(R * R - 1, C))
