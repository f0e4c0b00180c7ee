"""The dense two-pass path (``-O2``) and the ``--compact_frac -1`` auto-tune
of the port against the JAX package's, with the same parameters, rays and
random draws (the port's generator streams differ from ``jax.random``'s, so
each test either renders deterministically — ``perturb=False``,
``train=False`` — or hands the port the uniforms the JAX key draws).

Tolerances: ``sample_pdf`` rtol 1e-5, plus, per sample, four ulp of the
cdf times the slope of the inverse cdf there (bin width / cdf step): the two
cumsums round differently in the last place, and a u inside a narrow cdf
step moves its depth by that slope; render outputs rtol 1e-5, atol 1e-6 and gradients 3e-4
of each leaf's largest entry, as in ``test_torch_renderer.py`` and
``test_torch_trainer.py`` (f32 against f32 through the grid encode, the
heads and a 16-sample composite, summed over rays in another order).  The
trainer step's gradients are held to the same 3e-4, with room for one
column of one kernel: at 8,192 samples a ReLU pre-activation can lie within
rounding of zero (one of 6.8e-7 against O(1) activations was seen), take the
other side of the kink in one of the two implementations, and move one
column of the kernel it feeds by that sample's share — 9e-4 of the leaf
when seen, held to 1e-3.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine import trainer as jtrainer
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import composite as jcomp
from customnerf_tpu.ops import grid as jgrid
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import RayBatch
from customnerf_torch.engine import convert
from customnerf_torch.engine import trainer as ttrainer
from customnerf_torch.models import field as tfield
from customnerf_torch.models import renderer as tren
from customnerf_torch.ops import composite as tcomp
from customnerf_torch.ops import grid as tgrid
from customnerf_torch.ops import occupancy as tocc

GRID = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
            desired_resolution=64)
BOUND, T, UP = 2.0, 8, 8
FLAGS = ("-O2 --grid_levels 4 --grid_level_dim 2 --grid_base_resolution 4 "
         "--log2_hashmap_size 10 --desired_resolution 64 --num_steps 8 "
         "--upsample_steps 8 --bound 2 --train_conf 0.01 --soft_mask "
         "--data_type synthetic --iters 100 --lr 0.01").split()


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.rand(n, 3).astype(np.float32) - 0.5) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[0], d[0] = [3.0, 3.0, 0.0], [0.0, 0.0, 1.0]          # AABB miss
    return o, d


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _grads_close(tgrads, jgrads, n_leaves, share=3e-4, flip_share=None):
    """Every leaf to ``share`` of its largest entry.  With ``flip_share``,
    one column of one kernel may instead sit within ``flip_share``: a ReLU
    that one side rounds across its kink (module docstring)."""
    jl, tl = _leaves(jgrads), _leaves(tgrads)
    assert jl.keys() == tl.keys() and len(jl) == n_leaves
    flipped = []
    for path, gj in jl.items():
        name, gt = jax.tree_util.keystr(path), np.asarray(tl[path])
        scale = np.abs(gj).max()
        assert scale > 0, name
        if flip_share is not None and gj.ndim == 2:
            excess = (np.abs(gt - gj) - 1e-4 * np.abs(gj)).max(axis=0) / scale
            cols = np.nonzero(excess > share)[0]
            assert excess.max() <= flip_share, (name, excess.max())
            flipped += [(name, int(c)) for c in cols]
            keep = np.ones(gj.shape[1], bool)
            keep[cols] = False
            gt, gj = gt[:, keep], gj[:, keep]
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=share * scale, err_msg=name)
    assert len(flipped) <= 1, flipped


# ----------------------------------------------------------------- sample_pdf
@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    rng = np.random.RandomState(3)
    B, n_bins, n = 64, 15, 24
    bins = np.sort(rng.rand(B, n_bins).astype(np.float32) * 4 + 1, axis=-1)
    w = rng.rand(B, n_bins - 1).astype(np.float32) ** 4
    w[:4] = 0.0                                   # all-zero weights: uniform pdf
    w[4, 3] = 1e3                                 # one spike
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcomp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), n,
                                       det=det))
    u = None if det else torch.tensor(np.asarray(jax.random.uniform(key, (B, n))))
    got = tcomp.sample_pdf(torch.tensor(bins), torch.tensor(w), n, det=det, u=u)
    # the inverse cdf's slope at each sample, from an f64 cdf
    pdf = (w + 1e-5).astype(np.float64)
    cdf = np.concatenate([np.zeros((B, 1)), np.cumsum(pdf / pdf.sum(-1, keepdims=True), -1)], -1)
    uu = u.numpy() if u is not None else np.broadcast_to(
        np.linspace(0.5 / n, 1 - 0.5 / n, n), (B, n))
    i = np.clip(np.array([np.searchsorted(c, q, side="right") for c, q in zip(cdf, uu)]) - 1,
                0, n_bins - 2)
    step = np.take_along_axis(np.diff(cdf, axis=-1), i, -1)
    width = np.take_along_axis(np.diff(bins, axis=-1), i, -1)
    tol = 1e-5 * np.abs(want) + 1e-6 + 4 * 2.0 ** -24 * width / np.maximum(step, 1e-5)
    assert (np.abs(got.numpy() - want) <= tol).all(), np.abs(got.numpy() - want).max()
    assert (np.diff(got.numpy(), axis=-1) >= 0).all() or not det
    gen = torch.Generator().manual_seed(0)
    drawn = tcomp.sample_pdf(torch.tensor(bins), torch.tensor(w), n, generator=gen)
    assert drawn.shape == (B, n) and bool((drawn >= 1).all() and (drawn <= 5).all())


def test_neus_helpers_match_jax():
    rng = np.random.RandomState(4)
    sdf = rng.randn(16, 12).astype(np.float32)
    for jf, tf in ((jcomp.sdf_to_alpha, tcomp.sdf_to_alpha),
                   (jcomp.sdf_to_w, tcomp.sdf_to_w)):
        for a, b in zip(jf(jnp.asarray(sdf), 3.0), tf(torch.tensor(sdf), 3.0)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    alpha = rng.rand(16, 12).astype(np.float32)
    np.testing.assert_allclose(tcomp.alpha_to_w(torch.tensor(alpha)).numpy(),
                               np.asarray(jcomp.alpha_to_w(jnp.asarray(alpha))),
                               rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------- render_rays
def _fields(gridtype, seed=0):
    jspec, tspec = jgrid.GridSpec(**GRID, gridtype=gridtype), tgrid.GridSpec(
        **GRID, gridtype=gridtype)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=BOUND, grid=jspec,
                                             compute_dtype="float32"))
    tf = tfield.NeRFField(tfield.FieldConfig(bound=BOUND, grid=tspec), device="cpu")
    assert tf.fused and tf.grid_table.shape == (tspec.table_size, 2)
    params = convert.params_to_flax(tf.state_dict())
    rng = np.random.RandomState(seed)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.5).astype(np.float32)
    tf.load_state_dict(convert.params_from_flax(params))
    return jf, tf, params


@pytest.fixture(scope="module", params=["tiled", "hash"])
def dense_setup(request):
    jf, tf, params = _fields(request.param)
    n = 37
    o, d = _rays(n, 1)
    rng = np.random.RandomState(2)
    target = rng.rand(n, 3).astype(np.float32)
    mask = (rng.rand(n) < 0.5).astype(np.float32)
    s = jren.RenderSettings(bound=BOUND, num_steps=T, upsample_steps=UP, soft_mask=True)
    ts = tren.RenderSettings(bound=BOUND, num_steps=T, upsample_steps=UP, soft_mask=True)
    return jf, params, tf, o, d, target, mask, s, ts


def _loss(out, target, mask, lib):
    m = lib.mean if lib is jnp else torch.mean
    return (m((out["image"] - target) ** 2)
            + 0.01 * m((out["render_mask"][..., 0] - mask) ** 2))


@pytest.mark.parametrize("train,bg", [(False, None), (False, (0.2, 0.5, 0.9)),
                                      (True, None)],
                         ids=["eval", "eval_bg", "train_same_draws"])
def test_render_rays_matches_jax(dense_setup, train, bg):
    jf, params, tf, o, d, target, mask, s, ts = dense_setup
    key = jax.random.PRNGKey(5)
    bg_np = None if bg is None else np.asarray(bg, np.float32)

    def jloss(p):
        out = jren.render_rays(jf, p, jnp.asarray(o), jnp.asarray(d), key, s,
                               train=train, perturb=train, bg_color=bg_np)
        return _loss(out, target, mask, jnp), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))

    draws = None
    if train:       # the uniforms render_rays draws from its key
        kp, kpdf = jax.random.split(key)
        draws = {"jitter": torch.tensor(np.asarray(jax.random.uniform(kp, (len(o), T)))),
                 "u": torch.tensor(np.asarray(jax.random.uniform(kpdf, (len(o), UP))))}
    tf.zero_grad(set_to_none=True)
    tout = tren.render_rays(tf, torch.tensor(o), torch.tensor(d), ts, train=train,
                            perturb=train, bg_color=None if bg is None else torch.tensor(bg_np),
                            draws=draws)
    tl = _loss(tout, torch.tensor(target), torch.tensor(mask), torch)
    tl.backward()
    tg = convert.params_to_flax({n: p.grad for n, p in tf.named_parameters()})

    assert tout["weights"].shape == (len(o), T + UP) and tout["stats"] == {}
    for k in ("image", "depth", "weights_sum", "render_mask", "weights"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for side in ("fg", "bg"):
        for k in ("image", "depth", "weights_sum"):
            np.testing.assert_allclose(tout[side][k].detach().numpy(),
                                       np.asarray(jout[side][k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{side}/{k}")
    np.testing.assert_array_equal(tout["mask"].numpy(), np.asarray(jout["mask"]))
    if bg is not None:
        np.testing.assert_allclose(tout["black_image"].detach().numpy(),
                                   np.asarray(jout["black_image"]), rtol=1e-5, atol=1e-6)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(tout["weights_sum"][0].detach()) == 0.0       # the miss ray
    _grads_close(tg, jg, 8)


def test_coarse_pass_runs_density_only_without_a_graph(dense_setup, monkeypatch):
    """The coarse pass feeds only stop-gradient weights: it takes the
    density-only head under no_grad; the fine pass the full head."""
    _, _, tf, o, d, _, _, _, ts = dense_setup
    seen = []
    real = tfield.fused_field_mlp

    def spy(x_en, view_en, weights, with_rgb=True):
        seen.append((x_en.shape[0], with_rgb, torch.is_grad_enabled()))
        return real(x_en, view_en, weights, with_rgb)

    monkeypatch.setattr(tfield, "fused_field_mlp", spy)
    tren.render_rays(tf, torch.tensor(o), torch.tensor(d), ts, train=True,
                     perturb=True, generator=torch.Generator().manual_seed(0))
    n = len(o)
    assert seen == [(n * T, False, False), (n * (T + UP), True, True)]


# ------------------------------------------------------------ trainer step
def test_o2_trainer_step_matches_jax(monkeypatch):
    """One ``-O2`` reconstruction step (render, loss, Adam with the grid at
    lr×10) against the JAX pieces with the same batch and pdf draws."""
    jopt, topt = jconfig.parse_args(FLAGS), tconfig.parse_args(FLAGS)
    assert not jopt.cuda_ray and not topt.cuda_ray and topt.grid_type == "tiled"
    spec = jtrainer.build_encoder_spec(jopt)
    assert isinstance(spec, jgrid.GridSpec)
    # the JAX field in its f32 setting (-O2 sets fp16: its trainer would
    # pick bf16 heads)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec,
                                             compute_dtype="float32"))
    field = ttrainer.build_field(topt, device="cpu")
    assert field.cfg.grid == tgrid.GridSpec(**GRID, gridtype="tiled")
    params = convert.params_to_flax(field.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    field.load_state_dict(convert.params_from_flax(params))

    n = 512
    o, d = _rays(n, 1)
    rgb = rng.rand(n, 3).astype(np.float32)
    mask = (rng.rand(n) < 0.4).astype(np.float32)
    s = jren.RenderSettings(bound=2.0, num_steps=T, upsample_steps=UP, soft_mask=True)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jren.render_rays(jf, p, jnp.asarray(o), jnp.asarray(d), key, s,
                               train=True, perturb=False)
        return (jopt.train_rgb * jnp.mean((out["image"] - rgb) ** 2)
                + jopt.train_conf * jnp.mean((out["render_mask"][..., 0] - mask) ** 2))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    from test_torch_trainer import _jax_tx
    tx = _jax_tx(jopt.lr, jopt.iters)
    updates, _ = tx.update(jgrads, tx.init(jp), jp)
    jnew = jax.tree_util.tree_map(lambda a, b: np.asarray(a + b), jp, updates)

    u = torch.tensor(np.asarray(jax.random.uniform(jax.random.split(key)[1], (n, UP))))
    real = tren.sample_pdf
    monkeypatch.setattr(tren, "sample_pdf",
                        lambda *a, **kw: real(*a, **dict(kw, u=u)))
    tt = ttrainer.Trainer(topt, field=field, device="cpu", log=lambda *_: None)
    assert tt.occ_state is None and tt._occ_extra() is None
    batch = RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                     rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=16, W=32,
                     img_path="parity", index=0)
    tloss, _, stats = tt.train_step(batch, perturb=False)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5) and stats == {}
    tgrads = convert.params_to_flax({k: p.grad for k, p in field.named_parameters()})
    _grads_close(tgrads, jax.tree_util.tree_map(np.asarray, jgrads), 8, flip_share=1e-3)
    tnew = _leaves(convert.params_to_flax(field.state_dict()))
    for path, want in _leaves(jnew).items():
        lr = topt.lr * (10.0 if "grid_table" in jax.tree_util.keystr(path) else 1.0)
        assert np.abs(tnew[path] - want).max() <= 2.0 * lr * (1 + 1e-4), path


# ---------------------------------------------------------- auto-tune
def _jax_autotune(fill, block, num_steps, upsample_steps, iter_density=10):
    """JAX ``Trainer._autotune_compaction`` on a stand-in trainer whose
    measured fill is ``fill``."""
    fake = types.SimpleNamespace(
        opt=types.SimpleNamespace(num_steps=num_steps, upsample_steps=upsample_steps,
                                  compact_block=block, compact_frac=-1),
        occ_state=types.SimpleNamespace(iter_density=iter_density),
        measure_slab_fill=lambda batch: fill, log=lambda *_: None, _compiled={})
    jtrainer.Trainer._autotune_compaction(fake, [None])
    return fake.opt.compact_frac


@pytest.mark.parametrize("block,num_steps", [(8, 16), (32, 40), (64, 40), (16, 64)])
def test_autotune_rule_matches_jax(block, num_steps):
    fills = sorted(set(np.round(np.linspace(0.0, 0.7, 71), 4).tolist()
                       + [0.318, 0.32, 0.6, 0.6000001, 0.61, 1e-4, 1.0]))
    opt = tconfig.parse_args(("-O --grid_type triplane --triplane_res 8 16 "
                              "--triplane_channels 4 2 --occ_grid_size 16 "
                              f"--compact_frac -1 --compact_block {block} "
                              f"--num_steps {num_steps} --upsample_steps 0").split())
    tr = ttrainer.Trainer(opt, device="cpu", log=lambda *_: None)
    tr.occ_state = tocc.state_from_grid(torch.ones(2, 16 ** 3) * 50, 1.0, 10.0,
                                        grid_size=16)
    for fill in fills:
        want = _jax_autotune(fill, block, num_steps, 0)
        assert ttrainer.compaction_frac(fill, block, num_steps) == want, fill
        tr.opt.compact_frac = -1
        tr.measure_slab_fill = lambda batch, f=fill: f
        tr._autotune_compaction([None])
        assert tr.opt.compact_frac == want, fill
    # still warming up: both leave the flag at -1 (compaction off)
    assert _jax_autotune(0.3, block, num_steps, 0, iter_density=4) == -1
    tr.occ_state.iter_density, tr.opt.compact_frac = 4, -1
    tr._autotune_compaction([None])
    assert tr.opt.compact_frac == -1


def test_measure_slab_fill_matches_jax_with_the_same_jitter(monkeypatch):
    flags = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
             "--num_steps 16 --upsample_steps 0 --compact_frac -1 --compact_block 8 "
             "--bound 2 --occ_grid_size 16").split()
    jopt, topt = jconfig.parse_args(flags), tconfig.parse_args(flags)
    rng = np.random.RandomState(6)
    dens = (rng.rand(2, 16 ** 3) < 0.3).astype(np.float32) * 50.0
    o, d = _rays(300, 7)
    fake = types.SimpleNamespace(
        opt=jopt, _compiled={}, root_key=jax.random.PRNGKey(3),
        occ_state=jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=16))
    batch = RayBatch(rgbs=None, mask=None, rays_o=torch.tensor(o), rays_d=torch.tensor(d),
                     H=1, W=300, img_path="", index=0)
    want = jtrainer.Trainer.measure_slab_fill(fake, types.SimpleNamespace(
        rays_o=o, rays_d=d))
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (300, 32))))
    tr = ttrainer.Trainer(topt, device="cpu", log=lambda *_: None)
    tr.occ_state = tocc.state_from_grid(torch.tensor(dens), 1.0, 10.0, grid_size=16)
    # the march draws its jitter with torch.rand: hand it JAX's draw
    real_rand, drawn = torch.rand, []

    def rand(*shape, **kw):
        size = shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape
        if tuple(size) == tuple(jitter.shape):
            drawn.append(kw.get("generator"))
            return jitter.clone()
        return real_rand(*shape, **kw)

    monkeypatch.setattr(torch, "rand", rand)
    got = tr.measure_slab_fill(batch)
    monkeypatch.undo()
    assert drawn == [tr.generator]
    assert 0.05 < want < 0.95
    assert got == pytest.approx(want, abs=1e-7)
