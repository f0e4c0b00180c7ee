"""``render_rays_fast`` of the port against the JAX package's, with the same
field parameters, occupancy grid and rays, ``perturb=False`` and compaction
on: outputs and the parameter gradients of a loss.

The compacted field evaluation is exact in the no-overflow regime and the
even-stride subsample with a block scale in the overflow regime; both sides
keep the same samples (tests/test_torch_compaction.py), so the comparison
is f32 against f32 through the encode, the MLP heads and a 16-sample
composite: 1e-5 relative on outputs, 1e-4 on gradients summed over rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import occupancy as jocc
from customnerf_tpu.ops import triplane as jtri
from customnerf_torch.engine import convert
from customnerf_torch.models import field as tfield
from customnerf_torch.models import renderer as tren
from customnerf_torch.ops import occupancy as tocc
from customnerf_torch.ops import triplane

RES, CH, BOUND, G = (8, 16), (4, 2), 2.0, 16
N_COARSE, N_KEEP = 32, 16


@pytest.fixture(scope="module")
def setup():
    spec = jtri.TriplaneSpec(resolutions=RES, channels=CH, bwd="matmul",
                             mm_bf16=False, bwd_chunk=256)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=BOUND, grid=spec))
    tf = tfield.NeRFField(tfield.FieldConfig(
        bound=BOUND, grid=triplane.TriplaneSpec(RES, CH)), device="cpu")
    params = convert.params_to_flax(tf.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.5).astype(np.float32)
    tf.load_state_dict(convert.params_from_flax(params))

    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    jo = jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)
    to = tocc.state_from_grid(torch.tensor(dens), 1.0, 10.0, grid_size=G)

    n = 45                                  # not a multiple of the block
    o = rng.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.rand(n, 3).astype(np.float32) - 0.5) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[0], d[0] = [3.0, 3.0, 0.0], [0.0, 0.0, 1.0]          # AABB miss
    target = rng.rand(n, 3).astype(np.float32)
    mask = (rng.rand(n) < 0.5).astype(np.float32)
    s = jren.RenderSettings(bound=BOUND, num_steps=N_KEEP, upsample_steps=0,
                            soft_mask=True)
    ts = tren.RenderSettings(bound=BOUND, num_steps=N_KEEP, upsample_steps=0,
                             soft_mask=True)
    return jf, params, tf, jo, to, o, d, target, mask, s, ts


def _jax_render(setup, frac, bg):
    jf, params, _, jo, _, o, d, target, mask, s, _ = setup

    def loss(p):
        out = jren.render_rays_fast(
            jf, p, jnp.asarray(o), jnp.asarray(d), jo, jax.random.PRNGKey(0),
            s, n_coarse=N_COARSE, n_keep=N_KEEP, train=True, perturb=False,
            bg_color=bg, compact_frac=frac, compact_block=8)
        l = (jnp.mean((out["image"] - target) ** 2)
             + 0.01 * jnp.mean((out["render_mask"][..., 0] - mask) ** 2))
        return l, out

    (l, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(l), out, grads


def _torch_render(setup, frac, bg):
    _, _, tf, _, to, o, d, target, mask, _, ts = setup
    tf.zero_grad(set_to_none=True)
    out = tren.render_rays_fast(
        tf, torch.tensor(o), torch.tensor(d), to, ts, n_coarse=N_COARSE,
        n_keep=N_KEEP, perturb=False,
        bg_color=None if bg is None else torch.tensor(bg),
        compact_frac=frac, compact_block=8)
    l = (((out["image"] - torch.tensor(target)) ** 2).mean()
         + 0.01 * ((out["render_mask"][..., 0] - torch.tensor(mask)) ** 2).mean())
    l.backward()
    grads = convert.params_to_flax(
        {n: p.grad for n, p in tf.named_parameters()})
    return float(l.detach()), out, grads


# frac 1.0: budget = G·K, no block can overflow; frac 0.5 at G·K = 128
# rounds up to the same 128 slots (the 128-slot rounding), still exact
@pytest.mark.parametrize("frac,bg", [(1.0, None), (0.5, (0.2, 0.5, 0.9))],
                         ids=["exact", "exact_bg"])
def test_render_rays_fast_matches_jax(setup, frac, bg):
    bg_np = None if bg is None else np.asarray(bg, np.float32)
    jl, jout, jg = _jax_render(setup, frac, bg_np)
    tl, tout, tg = _torch_render(setup, frac, bg_np)
    for k in ("image", "depth", "weights_sum", "render_mask", "weights"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for side in ("fg", "bg"):
        for k in ("image", "depth", "weights_sum"):
            np.testing.assert_allclose(
                tout[side][k].detach().numpy(), np.asarray(jout[side][k]),
                rtol=1e-5, atol=1e-6, err_msg=f"{side}/{k}")
    assert tl == pytest.approx(jl, rel=1e-5)
    assert float(tout["weights_sum"][0].detach()) == 0.0       # the miss ray
    flat_t = jax.tree_util.tree_leaves_with_path(tg)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j) == 8
    for path, gt in flat_t:
        gj = np.asarray(flat_j[path])
        assert np.abs(gj).max() > 0, path
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_render_rays_fast_overflow_regime_matches_jax(setup):
    """Every 8-ray block holds more valid samples than its 128-slot budget
    when the grid is fully occupied: both sides keep the same even-stride
    subsample and scale dt by n_valid / budget."""
    jf, params, tf, _, _, o, d, _, _, s, ts = setup
    full = np.full((2, G ** 3), 50.0, np.float32)
    jo = jocc.state_from_grid(full, 1.0, density_thresh=10.0, grid_size=G)
    to = tocc.state_from_grid(torch.tensor(full), 1.0, 10.0, grid_size=G)
    jout = jax.jit(lambda p: jren.render_rays_fast(
        jf, p, jnp.asarray(o), jnp.asarray(d), jo, jax.random.PRNGKey(0), s,
        n_coarse=N_COARSE, n_keep=N_KEEP, train=True, perturb=False,
        compact_frac=0.25, compact_block=16))(
            jax.tree_util.tree_map(jnp.asarray, params))
    with torch.no_grad():
        tout = tren.render_rays_fast(tf, torch.tensor(o), torch.tensor(d), to,
                                     ts, n_coarse=N_COARSE, n_keep=N_KEEP,
                                     compact_frac=0.25, compact_block=16)
    assert float(tout["stats"]["overflow_frac"]) > 0.5
    for k in ("image", "depth", "weights_sum", "render_mask"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_uncompacted_path_matches_compacted_when_exact(setup):
    tf, to, o, d, ts = (setup[i] for i in (2, 4, 5, 6, 10))
    kw = dict(n_coarse=N_COARSE, n_keep=N_KEEP)
    with torch.no_grad():
        a = tren.render_rays_fast(tf, torch.tensor(o), torch.tensor(d), to, ts,
                                  **kw)
        b = tren.render_rays_fast(tf, torch.tensor(o), torch.tensor(d), to, ts,
                                  compact_frac=1.0, compact_block=8, **kw)
    for k in ("image", "depth", "weights_sum"):
        torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=1e-7)
