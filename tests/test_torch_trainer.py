"""One reconstruction train step of the port against the JAX package's: the
same parameters, occupancy grid and batch, ``perturb=False``.  The JAX step
is composed here from the JAX package's own pieces — ``render_rays_fast``,
the trainer's loss, and the optax chain of ``Trainer.tx`` (zero_nans →
Adam(0.9, 0.99, 1e-15) → per-group lr with the grid at ×10, per-step decay).

Tolerances: loss 1e-5 relative; gradients 3e-4 of each leaf's largest
entry — f32 sums over 2048 rays of cotangents that passed through exp and
sigmoid, which XLA's fused CPU kernels round differently by a few ulp.  The first Adam update
is lr·g/(|g| + eps) ≈ ±lr: entries whose gradient is well above the
gradient mismatch must move alike (1e-4 of lr, a few ulp of the
parameters); entries with a
near-zero gradient may take either sign in f32 and are held to |Δ| ≤ 2·lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine.trainer import build_encoder_spec
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import RayBatch
from customnerf_torch.engine import convert
from customnerf_torch.engine.trainer import Trainer, build_field
from customnerf_torch.ops import occupancy as tocc

FLAGS = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
         "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
         "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
         "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01"
         ).split()
G = 16


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.rand(n, 3).astype(np.float32) - 0.5) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.rand(n, 3).astype(np.float32)
    mask = (rng.rand(n) < 0.4).astype(np.float32)
    return o, d, rgb, mask


def _jax_tx(lr, iters):
    """The optax chain of the JAX ``Trainer.tx`` (engine/trainer.py:158-186)."""
    def sched(scale):
        return lambda step: scale * lr * (0.1 ** jnp.minimum(step / iters, 1.0))

    def adam(lr_fn):
        return optax.chain(optax.zero_nans(),
                           optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
                           optax.scale_by_learning_rate(lr_fn))

    def label(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: "grid" if any(getattr(p, "key", None) == "grid_table"
                                          for p in path) else "mlp", params)

    return optax.multi_transform({"grid": adam(sched(10.0)),
                                  "mlp": adam(sched(1.0))}, label)


@pytest.fixture(scope="module")
def step_pair():
    return run_both_steps()


def run_both_steps(n_rays=2048):
    jopt = jconfig.parse_args(FLAGS)
    topt = tconfig.parse_args(FLAGS)
    assert jopt.cuda_ray and topt.cuda_ray and topt.cascade == jopt.cascade == 2
    # the JAX field in its f32 settings: under -O its trainer would pick
    # bf16 heads, and its tri-plane table gradient runs in bf16 by default
    spec = dataclasses.replace(build_encoder_spec(jopt), mm_bf16=False)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    field = build_field(topt, device="cpu")
    params = convert.params_to_flax(field.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    field.load_state_dict(convert.params_from_flax(params))

    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    jocc_state = jocc.state_from_grid(dens, 1.0, density_thresh=10.0,
                                      grid_size=G)
    o, d, rgb, mask = _batch(n_rays, 1)

    # --- the JAX step, from the JAX package's own functions ---------------
    s = jren.RenderSettings(bound=2.0, num_steps=16, upsample_steps=0,
                            soft_mask=True)

    def loss_fn(p):
        out = jren.render_rays_fast(
            jf, p, jnp.asarray(o), jnp.asarray(d), jocc_state,
            jax.random.PRNGKey(0), s, n_coarse=32, n_keep=16, train=True,
            perturb=False, compact_frac=0.5, compact_block=8)
        loss_c = jopt.train_rgb * jnp.mean((out["image"] - rgb) ** 2)
        loss_m = jopt.train_conf * jnp.mean(
            (out["render_mask"][..., 0] - mask) ** 2)
        return loss_c + loss_m

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    tx = _jax_tx(jopt.lr, jopt.iters)
    updates, _ = tx.update(jgrads, tx.init(jp), jp)
    jnew = jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map(
        lambda a, b: a + b, jp, updates))

    # --- the port's step ----------------------------------------------------
    tt = Trainer(topt, field=field, device="cpu", log=lambda *_: None)
    tt.occ_state = tocc.state_from_grid(torch.tensor(dens), 1.0, 10.0,
                                        grid_size=G)
    batch = RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                     rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=32,
                     W=64, img_path="parity", index=0)
    tloss, _, stats = tt.train_step(batch, perturb=False)
    tgrads = convert.params_to_flax({n: p.grad for n, p in
                                     field.named_parameters()})
    tnew = convert.params_to_flax(field.state_dict())
    return (float(jloss), jax.tree_util.tree_map(np.asarray, jgrads), jnew,
            params, float(tloss), tgrads, tnew, stats, topt.lr)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_step_loss_matches(step_pair):
    jloss, *_, tloss, _, _, stats, _ = step_pair
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert stats["budget"] == 128


def test_step_gradients_match(step_pair):
    _, jgrads, _, _, _, tgrads, *_ = step_pair
    jl, tl = _leaves(jgrads), _leaves(tgrads)
    assert jl.keys() == tl.keys() and len(jl) == 8
    for path, gj in jl.items():
        scale = np.abs(gj).max()
        assert scale > 0, path
        np.testing.assert_allclose(tl[path], gj, rtol=1e-4, atol=3e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_step_adam_update_matches(step_pair):
    _, jgrads, jnew, params, _, tgrads, tnew, _, lr = step_pair
    jl, tl, p0, gj = _leaves(jnew), _leaves(tnew), _leaves(params), _leaves(jgrads)
    for path in jl:
        key = jax.tree_util.keystr(path)
        lr_g = lr * (10.0 if "grid_table" in key else 1.0)
        dj, dt = jl[path] - p0[path], tl[path] - p0[path]
        # the update really is ±lr where the gradient is not tiny
        sure = np.abs(gj[path]) > 1e-3 * np.abs(gj[path]).max()
        assert sure.mean() > 0.05, key
        np.testing.assert_allclose(np.abs(dj[sure]), lr_g, rtol=1e-3)
        np.testing.assert_allclose(dt[sure], dj[sure], rtol=0, atol=1e-4 * lr_g,
                                   err_msg=key)
        assert np.abs(dt - dj).max() <= 2.0 * lr_g * (1 + 1e-4), key
        # untouched entries (zero gradient) do not move
        np.testing.assert_array_equal(dt[gj[path] == 0], 0.0)


def test_lr_schedule_and_groups():
    topt = tconfig.parse_args(FLAGS)
    tt = Trainer(topt, field=build_field(topt, device="cpu"), device="cpu",
                 log=lambda *_: None)
    assert tt.lr_at(0) == pytest.approx(0.01)
    assert tt.lr_at(50) == pytest.approx(0.01 * 0.1 ** 0.5)
    assert tt.lr_at(500) == pytest.approx(0.001)
    scales = sorted(g["lr_scale"] for g in tt.optimizer.param_groups)
    assert scales == [1.0, 10.0]
