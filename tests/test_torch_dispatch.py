"""K steps a dispatch (``--steps_per_dispatch``) on the CPU, against the
port's own single steps and the JAX package's scanned paths.

* Schedule: for epoch lengths 7, 24 and 25, K = 1, 3 and 8 and
  ``update_extra_interval`` 16, over two epochs, the global steps at which
  the occupancy refresh runs, the group lengths and the lr of each update
  equal those of the JAX ``Trainer.train_one_epoch`` (observed through spies
  on its ``update_extra_state``, ``train_many`` and ``train_step``; a spy
  advances the JAX optax state by a unit gradient and reads the lr it
  applies).  The lrs agree to 1e-5 relative: JAX computes them, and the
  Adam direction it scales, in f32.
* K steps against one step: ``train_many`` at K = 3 equals three
  ``train_step`` calls bit for bit — parameters, Adam state, occupancy
  state, losses, ``global_step`` — for ``-O`` and ``-O2``, with and without
  ``--batch_rays``; so does ``editing_steps_many`` at K = 2 against two
  ``editing_step`` calls (tiny SD stack, ``RESIZE`` 64).
* Against JAX's scan: the port's 3-step dispatch against the JAX
  ``train_many`` (K = 3) with the JAX march jitter handed to the port
  (``torch.rand`` patched, as ``tests/test_torch_dense.py`` does), and the
  port's ``editing_steps_many`` at K = 2 against the JAX one with every JAX
  draw handed over (``draws=``).  Tolerances per step are those of the
  single-step tests (``tests/test_torch_trainer.py``,
  ``tests/test_torch_editing.py``): each step's loss 1e-5 relative for
  reconstruction (1e-4 for ``loss_sds``), each parameter within 2·lr_g per
  step taken (Adam's first steps are ±lr, so an entry whose gradient is
  near zero may take either sign) and, for reconstruction, the median
  entry of each leaf within 1e-4·lr_g a step (the single step holds its
  entries with a gradient above 1e-3 of the largest to that; after the
  first step, Adam's ratio of two gradients moves mid-sized entries too,
  and 5-27 % of a leaf's entries left 1e-4·lr_g over three steps, by the
  CPU's thread count).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine import editing as jediting
from customnerf_tpu.engine import trainer as jtrainer
from customnerf_tpu.models import field as jfield
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import NeRFDataset, RayBatch
from customnerf_torch.engine import convert, editing
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.ops import occupancy as tocc

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import FLAGS, G, _batch, f32_field  # noqa: E402

quiet = lambda *_: None                                          # noqa: E731


# --------------------------------------------- capture-safe composite
@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 40), (4, 1)])
def test_cumprod_without_zeros_matches_torch_bitwise(shape):
    """``ops/composite.py``'s cumprod (a CUDA graph can hold its backward)
    equals ``torch.cumprod`` and its gradient bit for bit on inputs
    without zeros, the only inputs it takes (factors ≥ 1e-15)."""
    from customnerf_torch.ops.composite import _CumprodNonzero
    g = torch.Generator().manual_seed(0)
    x = (1.0 - torch.rand(shape, generator=g) + 1e-15).requires_grad_()
    cot = torch.randn(shape, generator=g)
    want = torch.cumprod(x, dim=-1)
    got = _CumprodNonzero.apply(x)
    assert torch.equal(want, got)
    assert torch.equal(torch.autograd.grad(want, x, cot)[0],
                       torch.autograd.grad(got, x, cot)[0])


# ------------------------------------------------------------- schedule
EPOCH_LENGTHS = (7, 24, 25)
KS = (1, 3, 8)
INTERVAL = 16


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    jopt = jconfig.parse_args(FLAGS + ["--update_extra_interval", str(INTERVAL)])
    return jtrainer.Trainer("df", jopt, workspace=str(tmp_path_factory.mktemp("j")),
                            use_checkpoint="scratch")


def _jax_schedule(jtr, n, k):
    """Two JAX epochs of ``n`` batches at K = ``k`` through spies: (refresh
    steps, group lengths, lr of each update)."""
    jtr.opt = dataclasses.replace(jtr.opt, steps_per_dispatch=k)
    jtr.global_step, jtr.epoch = 0, 1
    jtr.opt_state = jtr.tx.init(jtr.params)
    ones = jax.tree_util.tree_map(jnp.ones_like, jtr.params)
    update = jax.jit(jtr.tx.update)
    refreshes, groups, lrs = [], [], []

    def advance(steps):
        groups.append(steps)
        for _ in range(steps):
            upd, jtr.opt_state = update(ones, jtr.opt_state, jtr.params)
            # Adam's direction is 1 for a unit gradient: the update is −lr
            lrs.append(-float(upd["params"]["feature_net"]["hidden_0"]["kernel"][0, 0]))

    def many(batches, keys):
        advance(len(batches))
        z = np.zeros(len(batches), np.float32)
        return z, {"loss_c": z}

    def step(batch, key):
        advance(1)
        return 0.0, {"loss_c": np.float32(0.0)}

    jtr.update_extra_state = lambda: refreshes.append(jtr.global_step)
    jtr.train_many, jtr.train_step = many, step
    for _ in range(2):
        jtr.train_one_epoch(list(range(n)))
    return refreshes, groups, lrs


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", EPOCH_LENGTHS)
def test_schedule_matches_jax(jax_trainer, n, k):
    want = _jax_schedule(jax_trainer, n, k)
    topt = tconfig.parse_args(FLAGS + ["--update_extra_interval", str(INTERVAL),
                                       "--steps_per_dispatch", str(k)])
    tr = Trainer(topt, device="cpu", log=quiet)
    batch = _ray_batch(64, 0)
    refreshes, groups, lrs = [], [], []
    refresh, many, step = tr.update_extra_state, tr.train_many, tr.train_step

    def spy_refresh():
        refreshes.append(tr.global_step)
        refresh()

    def spy_many(batches):
        groups.append(len(batches))
        return many(batches)

    def spy_step(b, **kw):
        groups.append(1)
        return step(b, **kw)

    adam = tr.optimizer.step

    def spy_adam(*a, **kw):
        lrs.append(tr.optimizer.param_groups[1]["lr"])     # the mlp group
        return adam(*a, **kw)

    tr.update_extra_state, tr.train_many, tr.train_step = spy_refresh, spy_many, spy_step
    tr.optimizer.step = spy_adam
    for epoch in (1, 2):
        tr.epoch = epoch
        tr.train_one_epoch([batch] * n)
    assert (refreshes, groups) == want[:2]
    assert tr.global_step == 2 * n == len(lrs)
    np.testing.assert_allclose(lrs, want[2], rtol=1e-5)


# ------------------------------------------------ K steps against one step
def _ray_batch(n, seed):
    o, d, rgb, mask = _batch(n, seed)
    return RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                    rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=1, W=n,
                    img_path=f"b{seed}", index=seed)


DENSE = ("-O2 --grid_levels 4 --grid_base_resolution 4 --log2_hashmap_size 10 "
         "--desired_resolution 64 --num_steps 8 --upsample_steps 8 --bound 2 "
         "--train_conf 0.01 --soft_mask --data_type synthetic --iters 100 "
         "--lr 0.01").split()
CASES = {"O": FLAGS, "O_batch_rays": FLAGS + ["--batch_rays", "96"],
         "O2": DENSE, "O2_batch_rays": DENSE + ["--batch_rays", "96"]}


def _state(tr):
    occ = tr.occ_state
    return ([p.detach().clone() for p in tr.field.parameters()],
            [v.clone() for s in tr.optimizer.state.values() for v in s.values()],
            None if occ is None else (occ.density_grid.clone(), occ.bitfield.clone(),
                                      occ.mean_density.clone(), occ.iter_density))


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_many_equals_single_steps_bitwise(case):
    """An epoch of 3 batches at K = 3 (one ``train_many``) against K = 1
    (three ``train_step``), both refreshing once before the first step."""
    flags = CASES[case] + ["--update_extra_interval", "16"]
    batches = [_ray_batch(128, s) for s in range(3)]
    runs = []
    for k in (1, 3):
        tr = Trainer(tconfig.parse_args(flags + ["--steps_per_dispatch", str(k)]),
                     device="cpu", log=quiet)
        losses = []
        step, many = tr.train_step, tr.train_many

        def spy_step(b, **kw):
            out = step(b, **kw)
            losses.append(out[0])
            return out

        def spy_many(bs):
            out = many(bs)
            losses.extend(out[0])
            return out

        tr.train_step, tr.train_many = spy_step, spy_many
        tr.epoch = 1
        avg = tr.train_one_epoch(batches)
        runs.append((tr, losses, avg))
    (a, la, avg_a), (b, lb, avg_b) = runs
    assert len(la) == len(lb) == 3 and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert a.global_step == b.global_step == 3 and a.n_updates == b.n_updates == 3
    assert _equal(_state(a), _state(b))
    assert (a.occ_state is None) == case.startswith("O2")
    assert avg_a == avg_b


# ------------------------------------------------------- against JAX's scan
def test_train_many_matches_jax_scan(tmp_path, monkeypatch):
    """The port's ``train_many`` (3 steps, K = 3 on the CPU) against the
    JAX ``Trainer.train_many`` with keys 0, 1, 2: the same parameters,
    occupancy grid and batches, JAX's march jitter handed to the port."""
    jopt, topt = jconfig.parse_args(FLAGS), tconfig.parse_args(FLAGS)
    spec = dataclasses.replace(jtrainer.build_encoder_spec(jopt), mm_bf16=False)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    field = f32_field(topt)
    params = convert.params_to_flax(field.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    field.load_state_dict(convert.params_from_flax(params))
    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    n = 512
    raw = [_batch(n, s + 1) for s in range(3)]

    jtr = jtrainer.Trainer("df", jopt, field=jf, workspace=str(tmp_path),
                           use_checkpoint="scratch")
    jtr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jtr.opt_state = jtr.tx.init(jtr.params)
    jtr.occ_state = jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)
    jb = [RayBatch(rgbs=rgb, mask=m, rays_o=o, rays_d=d, H=1, W=n, img_path="", index=i)
          for i, (o, d, rgb, m) in enumerate(raw)]
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    jlosses, _ = jtr.train_many(jb, keys)
    jlosses = np.asarray(jlosses)
    jnew = jax.tree_util.tree_map(np.asarray, jtr.params)

    n_coarse = 2 * topt.num_steps
    jitters = [torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(jax.random.split(k)[1])[0], (n, n_coarse)))) for k in keys]
    real_rand, drawn = torch.rand, []

    def rand(*shape, **kw):
        size = shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape
        if tuple(size) == (n, n_coarse):
            drawn.append(kw.get("generator"))
            return jitters[len(drawn) - 1].clone()
        return real_rand(*shape, **kw)

    tt = Trainer(topt, field=field, device="cpu", log=quiet)
    tt.occ_state = tocc.state_from_grid(torch.tensor(dens), 1.0, 10.0, grid_size=G)
    monkeypatch.setattr(torch, "rand", rand)
    tlosses, _ = tt.train_many([_ray_batch(n, s + 1) for s in range(3)])
    monkeypatch.undo()
    assert drawn == [tt.generator] * 3
    # each step's loss: 1e-5 relative, as the single step
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=1e-5)
    tnew = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_flax(field.state_dict())))
    for path, want in jax.tree_util.tree_leaves_with_path(jnew):
        key = jax.tree_util.keystr(path)
        lr_g = topt.lr * (10.0 if "grid_table" in key else 1.0)
        d = np.abs(tnew[path] - want)
        # within 2·lr_g a step; the median entry within 1e-4·lr_g a step
        assert d.max() <= 3 * 2.0 * lr_g * (1 + 1e-4), key
        assert np.median(d) <= 3 * 1e-4 * lr_g, key


# ------------------------------------------------------------------ editing
from test_torch_editing import (FLAGS as EDIT_FLAGS, SIDE, UNET, VAE,  # noqa: E402
                                random_params, tiny_guidance)
from test_torch_editing import f32_field as edit_f32_field  # noqa: E402
from customnerf_tpu.guidance.scheduler import DDPMSchedule as JSchedule  # noqa: E402
from customnerf_tpu.guidance.sds import StableDiffusionGuidance as JGuidance  # noqa: E402
from customnerf_tpu.guidance.unet import UNet2DCondition as JUNet  # noqa: E402
from customnerf_tpu.guidance.unet import UNetConfig as JUNetConfig  # noqa: E402
from customnerf_tpu.guidance.vae import AutoencoderKL as JVAE  # noqa: E402
from customnerf_tpu.guidance.vae import VAEConfig as JVAEConfig  # noqa: E402


@pytest.fixture(scope="module")
def edit_world(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("edit"))
    topt = tconfig.parse_args(EDIT_FLAGS + ["--workspace", ws, "--g_only"])
    rng = np.random.RandomState(0)
    field = edit_f32_field(topt)
    params = convert.params_to_flax(field.state_dict())
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    loader = NeRFDataset(topt, "train", device="cpu").dataloader()
    batches = [loader.item(i) for i in range(2)]
    pt = {b.img_path: dict(pt_rgb_bg=torch.tensor(rng.rand(b.H, b.W, 3).astype(np.float32)),
                           pt_mask=torch.tensor(rng.rand(b.H, b.W, 2).astype(np.float32)),
                           match_probs=None) for b in batches}
    text = {k: torch.tensor(rng.randn(2, 77, 32).astype(np.float32))
            for k in ("global", "local")}
    guidance = tiny_guidance(topt)
    key = jax.random.PRNGKey(0)
    ju, jv = JUNet(JUNetConfig(**UNET)), JVAE(JVAEConfig(**VAE))
    unet_p = random_params(jax.eval_shape(ju.init, key, jnp.zeros((1, 8, 8, 4)),
                                          jnp.zeros((1,), jnp.int32),
                                          jnp.zeros((1, 77, 32))), 1)
    vae_p = random_params(jax.eval_shape(
        lambda k: jv.init({"params": k}, jnp.zeros((1, 64, 64, 3)), k), key), 2)
    guidance.unet.load_state_dict(convert.state_from_flax(unet_p))
    guidance.vae.load_state_dict(convert.state_from_flax(vae_p))
    return dict(topt=topt, params=params, dens=dens, batches=batches, pt=pt,
                text=text, guidance=guidance, unet_p=unet_p, vae_p=vae_p, ju=ju, jv=jv)


def _edit_trainer(w):
    field = edit_f32_field(w["topt"])
    field.load_state_dict(convert.params_from_flax(w["params"]))
    tr = Trainer(w["topt"], field=field, device="cpu", log=quiet, guidance=w["guidance"])
    tr.occ_state = tocc.state_from_grid(torch.tensor(w["dens"]), 1.0, 10.0, grid_size=G)
    tr.text_z, tr.text_z_fg = w["text"]["global"], w["text"]["local"]
    tr.pt_dict = {k: dict(v) for k, v in w["pt"].items()}
    return tr


def test_editing_steps_many_equals_single_steps_bitwise(edit_world, monkeypatch):
    monkeypatch.setattr(editing, "RESIZE", SIDE)
    w = edit_world
    a, b = _edit_trainer(w), _edit_trainer(w)
    la = []
    for batch in w["batches"]:
        a.global_step += 1
        la.append(a.train_step(batch))
    lb, aux = editing.editing_steps_many(b, w["batches"])
    assert a.global_step == b.global_step == 2 and a.n_updates == b.n_updates == 2
    assert torch.equal(torch.stack([x[0] for x in la]), lb)
    for k in ("loss_sds", "loss_bg"):
        assert torch.equal(torch.stack([x[1][k] for x in la]), aux[k])
    assert _equal(_state(a), _state(b))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_editing_steps_many_matches_jax(edit_world, monkeypatch, tmp_path):
    """The JAX ``editing_steps_many`` at K = 2 (its resize shrunk to 64², as
    ``tests/test_editing_scan.py`` does) against the port's with every JAX
    draw handed over: bg colour, t, march jitter, VAE and SDS noise."""
    w = edit_world
    monkeypatch.setattr(editing, "RESIZE", SIDE)
    orig_resize = jax.image.resize

    def small_resize(x, shape, method="bilinear", **kw):
        if len(shape) == 4 and shape[1] == 512:
            shape = (shape[0], SIDE, SIDE, shape[3])
        return orig_resize(x, shape, method=method, **kw)

    monkeypatch.setattr(jax.image, "resize", small_resize)
    jopt = jconfig.parse_args(EDIT_FLAGS + ["--g_only"])
    spec = dataclasses.replace(jtrainer.build_encoder_spec(jopt), mm_bf16=False)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    jg = JGuidance.__new__(JGuidance)
    jg.opt, jg.unet, jg.vae, jg.cd_kv = jopt, w["ju"], w["jv"], None
    jg.unet_params, jg.vae_params = w["unet_p"], w["vae_p"]
    jg.scheduler = JSchedule()
    jg.alphas = jg.scheduler.alphas_cumprod
    jg.num_train_timesteps = 1000
    jg.min_step, jg.max_step = 20, int(1000 * jopt.max_ratio)
    jtr = jtrainer.Trainer("df", jopt, field=jf, guidance=jg, workspace=str(tmp_path),
                           use_checkpoint="scratch")
    jtr.params = jax.tree_util.tree_map(jnp.asarray, w["params"])
    jtr.opt_state = jtr.tx.init(jtr.params)
    jtr.occ_state = jocc.state_from_grid(w["dens"], 1.0, density_thresh=10.0, grid_size=G)
    jtr.text_z = jnp.asarray(w["text"]["global"].numpy())
    jtr.text_z_fg = jnp.asarray(w["text"]["local"].numpy())
    jtr.pt_dict = {k: {kk: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
                       for kk, v in e.items()} for k, e in w["pt"].items()}
    keys = [jax.random.PRNGKey(30 + i) for i in range(2)]
    jlosses, jaux = jediting.editing_steps_many(jtr, w["batches"], keys)
    jnew = jax.tree_util.tree_map(np.asarray, jtr.params)

    nchw = lambda a: torch.tensor(np.asarray(a).transpose(0, 3, 1, 2).copy())  # noqa: E731
    draws, jitters = [], []
    n, n_coarse = w["batches"][0].rays_o.shape[0], 2 * jopt.num_steps
    for i, key in enumerate(keys):
        k_bg, k_t, k_step = jax.random.split(key, 3)
        k_render, k_vae, k_noise = jax.random.split(k_step, 3)
        draws.append(dict(
            bg_color=torch.tensor(np.asarray(jax.random.uniform(k_bg, (3,)))),
            t=jg.sample_timestep(k_t, i + 1, 1.0),
            vae_noise=nchw(jax.random.normal(k_vae, (1, 8, 8, 4))),
            noise=nchw(jax.random.normal(k_noise, (1, 8, 8, 4)))))
        jitters.append(torch.tensor(np.asarray(jax.random.uniform(
            jax.random.split(k_render)[0], (n, n_coarse)))))
    real_rand, drawn = torch.rand, []

    def rand(*shape, **kw):
        size = shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape
        if tuple(size) == (n, n_coarse):
            drawn.append(1)
            return jitters[len(drawn) - 1].clone()
        return real_rand(*shape, **kw)

    tr = _edit_trainer(w)
    monkeypatch.setattr(torch, "rand", rand)
    tlosses, taux = editing.editing_steps_many(tr, w["batches"], draws=draws)
    monkeypatch.setattr(torch, "rand", real_rand)
    assert len(drawn) == 2 and tr.global_step == jtr.global_step == 2
    np.testing.assert_allclose(taux["loss_bg"].numpy(), np.asarray(jaux["loss_bg"]),
                               rtol=1e-5)
    np.testing.assert_allclose(taux["loss_sds"].numpy(), np.asarray(jaux["loss_sds"]),
                               rtol=1e-4)
    tnew = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_flax(tr.field.state_dict())))
    for path, want in jax.tree_util.tree_leaves_with_path(jnew):
        key = jax.tree_util.keystr(path)
        lr_g = tr.opt.lr * (10.0 if "grid_table" in key else 1.0)
        assert np.abs(tnew[path] - want).max() <= 2 * 2.0 * lr_g * (1 + 1e-4), key
