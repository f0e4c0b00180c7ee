"""Leaf ops of the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both.  f32 against f32
elementwise math: the two libraries call the same libm-class kernels, so the
tolerance is a few ulp (rtol 1e-6) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.ops import activations as jact
from customnerf_tpu.ops import composite as jcomp
from customnerf_tpu.ops import frequency as jfreq
from customnerf_tpu.ops import ray as jray
from customnerf_torch.ops import activations, composite, frequency, ray


def _t(a):
    return torch.tensor(np.asarray(a))


def test_trunc_exp_forward_and_grad():
    x = np.array([-30.0, -15.5, -1.0, 0.0, 0.7, 14.9, 15.0, 16.0, 60.0, 80.0,
                  85.0, 200.0], np.float32)
    want = np.asarray(jact.trunc_exp(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jact.trunc_exp(v) * 2.0))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = activations.trunc_exp(xt)
    (got * 2.0).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6)
    # the clamps themselves: finite forward above 80, gradient capped at 15
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy()[-1], 2.0 * np.exp(15.0),
                               rtol=1e-6)


@pytest.mark.parametrize("multires", [2, 4])
def test_freq_encode(multires):
    rng = np.random.RandomState(multires)
    d = rng.randn(50, 3).astype(np.float32)
    want = np.asarray(jfreq.freq_encode(jnp.asarray(d), multires))
    got = frequency.freq_encode(_t(d), multires).numpy()
    assert got.shape == (50, frequency.freq_encode_dim(multires))
    assert frequency.freq_encode_dim(4) == 27
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_near_far_from_aabb_including_misses():
    rng = np.random.RandomState(0)
    o = rng.randn(64, 3).astype(np.float32) * 2.0
    d = rng.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # a sure miss (parallel to a face, outside the box) and a start inside
    o[0], d[0] = [3.0, 3.0, 0.0], [0.0, 0.0, 1.0]
    o[1] = [0.0, 0.0, 0.0]
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    wn, wf = jray.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(aabb), 0.05)
    gn, gf = ray.near_far_from_aabb(_t(o), _t(d), _t(aabb), 0.05)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-6)
    fmax = np.finfo(np.float32).max
    assert gn[0] == fmax and gf[0] == fmax
    assert float(gn[1]) == pytest.approx(0.05)    # min_near clamp
    assert (gn.numpy() == fmax).sum() == (np.asarray(wn) == fmax).sum() > 1


def test_alphas_and_weights():
    rng = np.random.RandomState(1)
    sig = rng.exponential(3.0, (16, 24)).astype(np.float32)
    dt = rng.rand(16, 24).astype(np.float32) * 0.1
    sig[0] = 0.0            # empty ray
    sig[1, 3] = 1e4         # opaque sample: later weights vanish
    wa = jcomp.alphas_from_sigmas(jnp.asarray(sig), jnp.asarray(dt))
    ga = composite.alphas_from_sigmas(_t(sig), _t(dt))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6,
                               atol=1e-7)
    ww = np.asarray(jcomp.weights_from_alphas(wa))
    gw = composite.weights_from_alphas(ga).numpy()
    # cumprod over 24 factors: a few ulp each
    np.testing.assert_allclose(gw, ww, rtol=1e-5, atol=1e-7)
    assert gw[0].sum() == 0.0
    assert gw[1, 4:].max() < 1e-6
