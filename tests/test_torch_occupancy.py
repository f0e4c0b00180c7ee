"""Occupancy grid of the port against the JAX package, on the CPU: a 16³
grid with two cascades (bound 2).  Integer and boolean outputs (bits, kept
set, slots, valid) must match exactly; f32 values bit for bit where both do
the same f32 ops in the same order (depths, dt_scale), else to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.ops import occupancy as jocc
from customnerf_tpu.ops import ray as jray
from customnerf_torch.engine import convert
from customnerf_torch.ops import occupancy as tocc
from customnerf_torch.ops import ray

G, CAS, BOUND = 16, 2, 2.0


def _grid(seed, frac=0.3):
    rng = np.random.RandomState(seed)
    dens = rng.exponential(20.0, (CAS, G ** 3)).astype(np.float32)
    dens *= rng.rand(CAS, G ** 3) < frac
    return dens


def _states(dens, mean=1.0, iter_density=10):
    js = jocc.state_from_grid(dens, mean, density_thresh=10.0,
                              iter_density=iter_density, grid_size=G)
    ts = tocc.state_from_grid(torch.tensor(dens), mean, 10.0,
                              iter_density=iter_density, grid_size=G)
    return js, ts


def test_packbits_bit_exact():
    dens = _grid(0)
    want = np.asarray(jocc.packbits(jnp.asarray(dens), 5.0))
    got = tocc.packbits(torch.tensor(dens), 5.0).numpy()
    assert got.dtype == np.uint8 and got.shape == (CAS * G ** 3 // 8,)
    np.testing.assert_array_equal(got, want)
    one = torch.zeros(1, 16)
    one[0, 0] = one[0, 9] = 5.0
    assert tocc.packbits(one, 1.0).tolist() == [1, 2]      # LSB first


def test_state_from_grid_and_numpy_conversion():
    dens = _grid(1)
    js, ts = _states(dens, mean=3.0)
    np.testing.assert_array_equal(ts.bitfield.numpy(), np.asarray(js.bitfield))
    back = convert.occupancy_from_numpy(
        np.asarray(js.density_grid), np.asarray(js.bitfield),
        np.asarray(js.mean_density), np.asarray(js.iter_density), G,
        device="cpu")
    assert torch.equal(back.bitfield, ts.bitfield)
    assert back.iter_density == 10 and back.grid_size == G


@pytest.mark.parametrize("iter_density", [3, 4, 5])
def test_occupancy_lookup_exact_across_cascades(iter_density):
    js, ts = _states(_grid(2), iter_density=iter_density)
    rng = np.random.RandomState(3)
    # points in both cascades, on cascade borders, and outside the bound
    xyz = (rng.rand(4000, 3) * 2 - 1).astype(np.float32) * 2.3
    xyz[:8] = [[1.0, 0, 0], [-1.0, 0.5, 0], [2.0, 2.0, 2.0], [0, 0, 0],
               [1.0000001, 0, 0], [0.999, -0.999, 0.2], [2.01, 0, 0],
               [-2.0, -2.0, -2.0]]
    want = np.asarray(jocc.occupancy_lookup(js, jnp.asarray(xyz), BOUND))
    got = tocc.occupancy_lookup(ts, torch.tensor(xyz), BOUND).numpy()
    np.testing.assert_array_equal(got, want)
    # warm-up (≤ 4 refreshes): everything inside the bound is occupied
    inside = np.abs(xyz).max(-1) <= BOUND
    assert not got.all()                      # outside points exist
    if iter_density <= tocc.WARMUP_UPDATES:
        np.testing.assert_array_equal(got, inside)
    else:
        assert 0.05 < got[inside].mean() < 0.6


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = (rng.rand(n, 3).astype(np.float32) - 0.5) * 1.5
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 1.0, 0.0]                       # an AABB miss
    return o, d


@pytest.mark.parametrize("frac,n_keep", [(0.3, 8), (0.9, 8), (0.3, 48)])
def test_march_kept_set_and_slots_identical(frac, n_keep):
    js, ts = _states(_grid(4, frac))
    o, d = _rays(96, 5)
    aabb = np.array([-BOUND] * 3 + [BOUND] * 3, np.float32)
    nj, fj = jray.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(aabb), 0.01)
    miss = nj >= fj
    nj, fj = jnp.where(miss, 0.0, nj), jnp.where(miss, 1.0, fj)
    zj, vj, sj = jocc.march_rays_occupancy(
        js, jnp.asarray(o), jnp.asarray(d), nj, fj, jax.random.PRNGKey(0),
        BOUND, n_coarse=64, n_keep=n_keep, perturb=False)
    zt, vt, st = tocc.march_rays_occupancy(
        ts, torch.tensor(o), torch.tensor(d), torch.tensor(np.asarray(nj)),
        torch.tensor(np.asarray(fj)), BOUND, n_coarse=64, n_keep=n_keep,
        perturb=False)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # depths at valid slots identify the kept candidates and their order
    np.testing.assert_array_equal(np.where(vt.numpy(), zt.numpy(), 0),
                                  np.where(np.asarray(vj), np.asarray(zj), 0))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if n_keep == 8:   # some rays overflow the keep budget (even-stride keep)
        assert (st.numpy() > 1).any()


def test_march_perturb_keeps_depth_order_and_bounds():
    _, ts = _states(_grid(6))
    o, d = _rays(64, 7)
    n, f = ray.near_far_from_aabb(torch.tensor(o), torch.tensor(d),
                                  torch.tensor([-BOUND] * 3 + [BOUND] * 3), 0.01)
    miss = n >= f
    n, f = torch.where(miss, 0.0, n), torch.where(miss, 1.0, f)
    gen = torch.Generator().manual_seed(0)
    z, v, _ = tocc.march_rays_occupancy(ts, torch.tensor(o), torch.tensor(d),
                                        n, f, BOUND, n_coarse=64, n_keep=16,
                                        perturb=True, generator=gen)
    dz = (f - n)[:, None] / 64
    zv = torch.where(v, z, torch.full_like(z, float("inf")))
    assert (zv.diff(dim=-1)[v[:, 1:]] >= 0).all()
    assert ((z >= n[:, None] - dz) | ~v).all() and ((z <= f[:, None] + dz) | ~v).all()


def _jax_jitter(key, cascade):
    out = []
    for _ in range(cascade):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (G ** 3, 3))))
    return np.stack(out)


def test_update_grid_matches_given_the_same_jitter():
    def jdens(x):
        return 30.0 * jnp.exp(-jnp.sum(x * x, -1) / 0.3) - 0.5

    def tdens(x):
        return 30.0 * torch.exp(-(x * x).sum(-1) / 0.3) - 0.5

    prev = _grid(8)
    js, ts = _states(prev, mean=2.0, iter_density=2)
    key = jax.random.PRNGKey(11)
    j1 = jocc.update_grid(js, jdens, BOUND, 10.0, key, chunk=1000)
    t1 = tocc.update_grid(ts, tdens, BOUND, 10.0, chunk=1000,
                          jitter=torch.tensor(_jax_jitter(key, CAS)))
    np.testing.assert_allclose(t1.density_grid.numpy(),
                               np.asarray(j1.density_grid), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(t1.mean_density),
                               float(j1.mean_density), rtol=1e-6)
    np.testing.assert_array_equal(t1.bitfield.numpy(), np.asarray(j1.bitfield))
    assert t1.iter_density == int(j1.iter_density) == 3
    # EMA: an all-zero density keeps 95 % of the previous grid
    t2 = tocc.update_grid(t1, lambda x: torch.zeros(x.shape[0]), BOUND, 10.0,
                          generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(t2.density_grid,
                               torch.clamp(t1.density_grid * 0.95, min=0.0))
