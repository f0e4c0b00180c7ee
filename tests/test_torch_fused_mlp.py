"""Fused field MLP: the port's plain version and ``fused_field_mlp`` against
the JAX package's ``_reference_forward`` and its Pallas kernel (interpret
mode), forward and the gradients for x, view_en and all seven weights.

Tolerance: f32 against f32 through 3-5 layers of ≤ 91-term dots summed in
another order — ≤ 1e-5 relative for O(1) activations; gradients accumulate
over the batch (B = 300), hence the looser atol there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.ops import fused_mlp_pallas as fmp
from customnerf_torch.ops import fused_mlp

SHAPES = [(72, 64), (64, 64), (64, 64), (64, 64), (64, 1), (91, 64), (64, 4)]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    B = 300                         # not a multiple of the Pallas tile (256)
    x = rng.randn(B, 72).astype(np.float32) * 0.5
    v = rng.randn(B, 27).astype(np.float32) * 0.5
    ws = [(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32) for s in SHAPES]
    return x, v, ws


@pytest.fixture
def interpret(monkeypatch):
    orig = fmp.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(fmp.pl, "pallas_call", interp_call)


def _loss_weights(B):
    rng = np.random.RandomState(1)
    return (rng.randn(B).astype(np.float32),
            rng.randn(B, 4).astype(np.float32))


def test_plain_forward_matches_jax_reference_and_pallas(problem, interpret):
    x, v, ws = problem
    js, jr = fmp._reference_forward(jnp.asarray(x), jnp.asarray(v),
                                    tuple(map(jnp.asarray, ws)))
    ps, pr = fmp._pallas_forward(jnp.asarray(x), jnp.asarray(v),
                                 tuple(map(jnp.asarray, ws)))
    n0 = fused_mlp.fused_mlp_forward.launches
    ts, tr = fused_mlp.fused_mlp_forward(torch.tensor(x), torch.tensor(v),
                                         [torch.tensor(w) for w in ws])
    assert fused_mlp.fused_mlp_forward.launches == n0   # CPU: no kernel
    assert ts.shape == (300,) and tr.shape == (300, 4)
    for want in ((js, jr), (ps, pr)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(want[1]), rtol=1e-5,
                                   atol=1e-5)


def test_fused_field_mlp_gradients_match_pallas_vjp(problem, interpret):
    x, v, ws = problem
    cs, cr = _loss_weights(x.shape[0])

    def jloss(xx, vv, w):
        s, r = fmp.fused_field_mlp(xx, vv, w)
        return jnp.sum(s * cs) + jnp.sum(r * cr)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(v),
                                            [jnp.asarray(w) for w in ws])
    xt = torch.tensor(x, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    s, r = fused_mlp.fused_field_mlp(xt, vt, wt)
    ((s * torch.tensor(cs)).sum() + (r * torch.tensor(cr)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jg[1]), rtol=1e-5,
                               atol=1e-5)
    for i, (a, b) in enumerate(zip(wt, jg[2])):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4, err_msg=f"weight {i}")


def test_backward_only_for_inputs_that_need_it(problem):
    x, v, ws = problem
    wt = [torch.tensor(w, requires_grad=(i == 6)) for i, w in enumerate(ws)]
    s, r = fused_mlp.fused_field_mlp(torch.tensor(x), torch.tensor(v), wt)
    r.sum().backward()          # sigma depends on no weight that trains
    assert wt[6].grad is not None and wt[0].grad is None
    want = torch.relu(torch.cat([torch.tensor(v), _fea(x, ws)], -1)
                      @ torch.tensor(ws[5])).sum(0)[:, None].expand(64, 4)
    torch.testing.assert_close(wt[6].grad, want, rtol=1e-5, atol=1e-4)


def _fea(x, ws):
    h = torch.relu(torch.tensor(x) @ torch.tensor(ws[0]))
    h = torch.relu(h @ torch.tensor(ws[1]))
    return h @ torch.tensor(ws[2])


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device_mix"])
def test_wrapper_rejects_bad_inputs(problem, bad):
    x, v, ws = problem
    x, v, ws = torch.tensor(x), torch.tensor(v), [torch.tensor(w) for w in ws]
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        ws[1] = ws[1][:, :32].contiguous()
    elif bad == "layout":
        ws[0] = ws[0].t().contiguous().t()      # same shape, not contiguous
    else:
        x = x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fused_mlp.fused_mlp_forward(x, v, ws)
