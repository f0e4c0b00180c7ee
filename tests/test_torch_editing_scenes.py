"""Multi-scene editing (N scenes × M prompts) and editing under
``--mesh_shape`` on the port, against the JAX package and one process.

* ``editing_step_scenes`` against the JAX ``editing_step_scenes`` with
  ``trainer.mesh = None``, at ``tests/test_editing.py``'s ``TinyGuidance``
  size with the 64² resize patch, S = 2 scenes from one state stacked
  twice: with a shared occupancy grid, and with per-scene pretrained
  fields, prompts and occupancy grids (``tests/test_editing_mesh.py:
  128-307``).  The JAX step takes its key; the port takes the draws that
  key makes there (bg colour, t, the VAE's and the SDS noise), and the
  march jitter is off on both sides (the JAX renderer and the port's
  ``render_image`` are wrapped with ``perturb=False``).  Each side renders
  its own pt entries from each scene's frozen field, and the port's are
  held against the JAX ones at 1e-5 (the f32 render).
  Both start from the same primed Adam state (zero first moments, unit
  second moments, count 1000), so that an update is ≈ lr·0.1·g.
  Tolerances: losses and ``loss_sds`` 1e-4 relative, each parameter's and
  first moment's change 1e-3 of the leaf's largest change — the gradient
  tolerance of ``tests/test_torch_editing.py`` (the cotangent multiplies the
  UNet's f32 rounding by cfg = 100).
* One S = 2 step equals two single-scene ``editing_step`` calls given the
  same draws and generators: the batched UNet call (one call of batch 4) is
  the per-scene call.  Same tolerances: the UNet's f32 sums run at another
  batch size.
* Two gloo processes (``tests/torch_mesh_worker.py``): sharded single-scene
  editing on ``data:2`` (a square frame; a 13×11 frame whose 143 rays do
  not divide the axis, edge-padded), a K = 2 ``editing_steps_many`` group,
  and the S = 2 step on ``scene:2`` and on ``data:2``, each equal to one
  process: gradients at 1e-3 of the leaf's largest entry (the
  ``tests/test_editing_mesh.py`` rule; the ranks sum in another order),
  losses 1e-4 relative (the workers run the UNet on one thread, the
  reference on two: cfg = 100 multiplies the f32 rounding of those sums).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.config import Config as JConfig
from customnerf_tpu.data.base import RayBatch as JRayBatch
from customnerf_tpu.engine import editing as jed
from customnerf_tpu.engine.trainer import Trainer as JTrainer
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine import convert, editing
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.ops import occupancy as tocc

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_worker as worker  # noqa: E402
from test_editing import TinyGuidance  # noqa: E402
from test_editing_mesh import _patched  # noqa: E402
from test_torch_mesh import run_two_ranks  # noqa: E402

FLAGS = dict(worker.EDIT, cuda_ray=True, occ_grid_size=worker.G, h=12, w=10)
LOSS_REL, LEAF_REL = 1e-4, 1e-3


def quiet(*_):
    pass


def occ_grid(seed, fill):
    rng = np.random.RandomState(seed)
    return ((rng.rand(2, worker.G ** 3) < fill) * 100.0).astype(np.float32)


def nchw(a):
    return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2).copy())


def close_by_leaf(got: dict, want: dict, rel=LEAF_REL, nonzero=True):
    """Each leaf within ``rel`` of its largest entry; ``nonzero``: every
    leaf has one (else a leaf may be zero on both sides)."""
    assert got.keys() == want.keys() and got
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        scale = np.abs(w).max()
        if not nonzero and scale == 0:
            assert np.abs(g).max() == 0, k
            continue
        assert scale > 0, k
        err = np.abs(g - w).max()
        assert err <= rel * scale, f"{k}: max error {err} > {rel} × {scale}"


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """The JAX trainer (TinyGuidance, -O on a 16³ grid) and its batches."""
    mp = pytest.MonkeyPatch()
    _patched(mp)
    jopt = JConfig(**dict(FLAGS, workspace=str(tmp_path_factory.mktemp("j"))))
    jtr = JTrainer("df", jopt, guidance=TinyGuidance(jopt), use_checkpoint="scratch")
    assert jtr.mesh is None and jtr.occ_state is not None
    render = jtr._render_fn()
    jtr._render_fn = lambda: (lambda *a, **k: render(*a, **dict(k, perturb=False)))
    jed.prepare_text_embeddings(jtr)
    # both sides edit the port's views (rays and images handed over)
    topt = tconfig.Config(**dict(FLAGS, workspace=str(tmp_path_factory.mktemp("t"))))
    loader = NeRFDataset(topt, "train", device="cpu").dataloader()
    batches = [loader.item(i) for i in range(2)]
    jbatches = [JRayBatch(rgbs=b.rgbs.numpy(), mask=b.mask.numpy(),
                          rays_o=b.rays_o.numpy(), rays_d=b.rays_d.numpy(), H=b.H,
                          W=b.W, img_path=b.img_path, index=b.index) for b in batches]
    yield jtr, jbatches, batches
    mp.undo()


def jax_draws(jtr, key, S, global_ratio, t_ratio_local):
    """The draws the JAX step makes from ``key`` for each scene
    (``editing.py:649-678``, ``one_b``'s noise, the VAE's k_vae)."""
    rs = np.random.RandomState(jtr.opt.seed)
    out = []
    for i in range(S):
        k_bg, k_t, k_step = jax.random.split(jax.random.fold_in(key, i), 3)
        local = rs.random() >= global_ratio
        t = jtr.guidance.sample_timestep(k_t, jtr.global_step,
                                         t_ratio_local if local else 1.0)
        _, k_vae, _ = jax.random.split(k_step, 3)
        out.append(dict(bg_color=torch.tensor(np.asarray(jax.random.uniform(k_bg, (3,)))),
                        t=int(t), noise=nchw(jax.random.normal(k_step, (1, 8, 8, 4))),
                        vae_noise=nchw(jax.random.normal(k_vae, (1, 8, 8, 4)))))
    return out


def port_trainer(jtr, ws):
    opt = tconfig.Config(**dict(FLAGS, workspace=ws))
    tr = Trainer(opt, device="cpu", log=quiet, guidance=worker.tiny_guidance(opt))
    tr.guidance.unet.load_state_dict(convert.state_from_flax(jtr.guidance.unet_params))
    tr.guidance.vae.load_state_dict(convert.state_from_flax(jtr.guidance.vae_params))
    tr.field.load_state_dict(convert.params_from_flax(jax.device_get(jtr.params)))
    tr.field_pretrained.load_state_dict(
        convert.params_from_flax(jax.device_get(jtr.params_pretrained)))
    for name in ("text_z", "text_z_fg"):
        setattr(tr, name, torch.tensor(np.asarray(getattr(jtr, name))))
    return tr


def primed_state(jtr, params_s):
    """The JAX optax state of S scenes with zero first moments, unit second
    moments and count 1000, made through ``convert.adam_to_optax``."""
    sd = convert.params_from_flax(jax.device_get(params_s))
    S = sd["grid_table"].shape[0]
    adam = {"step": torch.full((S,), 1000.0),
            "exp_avg": {k: torch.zeros_like(v) for k, v in sd.items()},
            "exp_avg_sq": {k: torch.ones_like(v) for k, v in sd.items()}}
    template = jed.stack_trees([jtr.opt_state] * S)
    return jax.tree_util.tree_map(jnp.asarray, convert.adam_to_optax(adam, template))


@pytest.mark.parametrize("per_scene", [False, True], ids=["shared_occ", "per_scene"])
def test_editing_step_scenes_matches_jax(jax_world, tmp_path, monkeypatch, per_scene):
    jtr, jbatches, batches = jax_world
    S, key = 2, jax.random.PRNGKey(3)
    jparams_s = jed.stack_trees([jtr.params, jtr.params])
    jopt_s = primed_state(jtr, jparams_s)
    dens = [occ_grid(11, 0.5), occ_grid(12, 0.9)]
    jtr.occ_state = jocc.state_from_grid(dens[0], 1.0, jtr.opt.density_thresh,
                                         grid_size=worker.G)
    jscenes, jocc_s = None, None
    if per_scene:
        pre1 = jax.tree_util.tree_map(
            lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(9), x.shape, x.dtype),
            jtr.params_pretrained)
        jscenes = [{"params_pretrained": jtr.params_pretrained},
                   {"params_pretrained": pre1,
                    **jed.prepare_scene_prompts(jtr, "a tiger in snow", "a tiger")}]
        jocc_s = jed.stack_trees([jocc.state_from_grid(d, 1.0, jtr.opt.density_thresh,
                                                       grid_size=worker.G) for d in dens])
    jtr.pt_dict, jtr._np_rng = {}, np.random.RandomState(jtr.opt.seed)
    draws = jax_draws(jtr, key, S, jtr.opt.global_ratio, jtr.opt.local_t_ratio)
    jp1, jo1, jlosses, jaux = jed.editing_step_scenes(
        jtr, jbatches, jparams_s, jopt_s, key, scenes=jscenes, occ_s=jocc_s)

    tr = port_trainer(jtr, str(tmp_path))
    tr.occ_state = tocc.state_from_grid(torch.tensor(dens[0]), 1.0,
                                        tr.opt.density_thresh, grid_size=worker.G)
    render_image = tr.render_image
    monkeypatch.setattr(tr, "render_image",
                        lambda *a, **k: render_image(*a, **dict(k, perturb=False)))
    scenes, occ_s = None, None
    if per_scene:
        pre = [convert.params_from_flax(jax.device_get(sc["params_pretrained"]))
               for sc in jscenes]
        scenes = [{"params_pretrained": pre[0]},
                  {"params_pretrained": pre[1],
                   "text_z": torch.tensor(np.asarray(jscenes[1]["text_z"])),
                   "text_z_fg": torch.tensor(np.asarray(jscenes[1]["text_z_fg"]))}]
        occ_s = editing.stack_trees([tocc.state_from_grid(torch.tensor(d), 1.0,
                                                          tr.opt.density_thresh,
                                                          grid_size=worker.G)
                                     for d in dens])
    params_s = convert.params_from_flax(jax.device_get(jparams_s))
    opt_s = convert.adam_from_optax(jax.device_get(jopt_s))
    assert opt_s["step"].tolist() == [1000.0, 1000.0]
    p1, o1, losses, aux = editing.editing_step_scenes(
        tr, batches, params_s, opt_s, draws, scenes=scenes, occ_s=occ_s,
        perturb=False)

    for i, b in enumerate(batches):
        np.testing.assert_allclose(tr.pt_dict[(i, b.img_path)]["pt_rgb_bg"].numpy(),
                                   np.asarray(jtr.pt_dict[(i, b.img_path)]["pt_rgb_bg"]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=LOSS_REL)
    np.testing.assert_allclose(aux["loss_sds"].numpy(), np.asarray(jaux["loss_sds"]),
                               rtol=LOSS_REL)
    np.testing.assert_allclose(aux["loss_bg"].numpy(), np.asarray(jaux["loss_bg"]),
                               rtol=LOSS_REL)
    want = convert.params_from_flax(jax.device_get(jp1))
    close_by_leaf({k: p1[k] - params_s[k] for k in want},
                  {k: want[k] - params_s[k] for k in want})
    jadam = convert.adam_from_optax(jax.device_get(jo1))
    assert o1["step"].tolist() == jadam["step"].tolist() == [1001.0, 1001.0]
    close_by_leaf(o1["exp_avg"], jadam["exp_avg"])
    table = p1["grid_table"]
    assert float((table[0] - table[1]).abs().max()) > 0


def test_adam_state_round_trip(jax_world):
    """``adam_from_optax`` → ``adam_to_optax`` rebuilds the stacked JAX
    optax state leaf for leaf (masked nodes kept)."""
    jtr = jax_world[0]
    rng = np.random.RandomState(4)
    state = jed.stack_trees([jtr.opt_state, jtr.opt_state])
    state = jax.tree_util.tree_map(
        lambda x: (rng.rand(*x.shape).astype(x.dtype) if x.dtype == np.float32
                   else np.full(x.shape, 7, x.dtype)), jax.device_get(state))
    adam = convert.adam_from_optax(state)
    assert adam["step"].tolist() == [7.0, 7.0]
    back = convert.adam_to_optax(adam, state)
    a, b = jax.tree_util.tree_flatten(state), jax.tree_util.tree_flatten(back)
    assert a[1] == b[1]
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_two_scenes_equal_two_single_scene_steps(tmp_path, monkeypatch):
    """One S = 2 step (one UNet call of batch 4) against two single-scene
    steps, each on its scene's state, draws, generator and gate."""
    tr = worker.edit_trainer("", str(tmp_path / "s"), h=12, w=10, cuda_ray=True)
    loader = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
    batches = [loader.item(0), loader.item(1)]
    params_s, opt_s = worker.scene_state(tr)
    rng = np.random.RandomState(5)
    draws = [dict(bg_color=torch.tensor(rng.rand(3).astype(np.float32)), t=300 + 100 * i,
                  noise=torch.tensor(rng.randn(1, 4, 8, 8).astype(np.float32)),
                  vae_noise=torch.tensor(rng.randn(1, 4, 8, 8).astype(np.float32)))
             for i in range(2)]
    pts = [dict(pt_rgb_bg=torch.rand(12, 10, 3, generator=torch.Generator().manual_seed(i)),
                match_probs=None) for i in range(2)]
    for i, b in enumerate(batches):
        tr.pt_dict[(i, b.img_path)] = pts[i]
    seeds = torch.randint(0, 2 ** 62, (2,), generator=torch.Generator().manual_seed(
        tr.opt.seed)).tolist()
    calls = []
    unet_forward = tr.guidance.unet.forward
    monkeypatch.setattr(tr.guidance.unet, "forward",
                        lambda x, *a, **k: calls.append(x.shape[0]) or unet_forward(x, *a, **k))
    p1, o1, losses, aux = editing.editing_step_scenes(tr, batches, params_s, opt_s, draws)
    assert calls == [4], calls

    for i in range(2):
        single = worker.edit_trainer("", str(tmp_path / f"one{i}"), h=12, w=10,
                                     cuda_ray=True)
        single.field.load_state_dict({k: v[i] for k, v in params_s.items()})
        worker.prime_adam(single)
        single.generator.manual_seed(seeds[i])
        for _ in range(i):
            single.np_rng.random()               # scene i takes the i-th gate draw
        single.pt_dict[batches[i].img_path] = pts[i]
        _, saux, _ = editing.editing_step(single, batches[i], draws=draws[i])
        assert float(aux["loss_sds"][i]) == pytest.approx(float(saux["loss_sds"]), rel=LOSS_REL)
        assert float(aux["loss_bg"][i]) == pytest.approx(float(saux["loss_bg"]), rel=LOSS_REL)
        got = {k: p1[k][i] - params_s[k][i] for k in params_s}
        want = {n: p.detach() - params_s[n][i] for n, p in single.field.named_parameters()}
        close_by_leaf(got, want, nonzero=False)
        assert float(want["grid_table"].abs().max()) > 0
    assert o1["step"].tolist() == [1001.0, 1001.0]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    torch.set_num_threads(2)
    ws = tmp_path_factory.mktemp("edit_single")
    single = worker.editing_cases("", str(ws))
    return run_two_ranks("editing", tmp_path_factory.mktemp("edit_mesh")), single


def _leaves(d, prefix):
    return {k: v for k, v in d.items() if k.startswith(prefix + "/")
            and not k.split("/", 1)[1].startswith(("loss", "step"))}


@pytest.mark.parametrize("case", ["square", "nonsquare"])
def test_sharded_single_scene_editing_matches_one_process(mesh_runs, case):
    mesh, single = mesh_runs
    for k in ("loss_sds", "loss_bg"):
        assert float(mesh[f"{case}/{k}"]) == pytest.approx(float(single[f"{case}/{k}"]),
                                                           rel=LOSS_REL)
    close_by_leaf(_leaves(mesh, case), _leaves(single, case), nonzero=False)
    assert np.abs(single[f"{case}/grid_table"]).max() > 0


def test_sharded_editing_steps_many_matches_one_process(mesh_runs):
    mesh, single = mesh_runs
    np.testing.assert_allclose(mesh["many/losses"], single["many/losses"], rtol=LOSS_REL)
    base = worker.edit_trainer("", "unused", h=16, w=16)
    start = {f"many/{n}": p.detach().numpy() for n, p in base.field.named_parameters()}
    close_by_leaf({k: mesh[k] - start[k] for k in start},
                  {k: single[k] - start[k] for k in start}, nonzero=False)
    assert np.abs(single["many/grid_table"] - start["many/grid_table"]).max() > 0


@pytest.mark.parametrize("case", ["scenes", "scenes_data"])
def test_scene_and_data_axes_match_one_process(mesh_runs, case):
    """S = 2 on ``scene:2`` (a scene a rank, gathered) and on ``data:2``."""
    mesh, single = mesh_runs
    np.testing.assert_allclose(mesh[f"{case}/losses"], single[f"{case}/losses"],
                               rtol=LOSS_REL)
    np.testing.assert_allclose(mesh[f"{case}/loss_sds"], single[f"{case}/loss_sds"],
                               rtol=LOSS_REL)
    np.testing.assert_array_equal(mesh[f"{case}/step"], single[f"{case}/step"])
    close_by_leaf(_leaves(mesh, case), _leaves(single, case), nonzero=False)
    assert np.abs(single[f"{case}/grid_table"]).max() > 0
