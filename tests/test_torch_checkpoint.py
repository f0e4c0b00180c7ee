"""Checkpoints interchange with the JAX package both ways (the ``.pth``
contract of ``customnerf_tpu/engine/checkpoint.py``), a ``model_only``
load (``--editing_from``) restores the occupancy grid, and the ring,
``latest`` and resume follow the reference.

Parameters and occupancy arrays are compared exactly (they are copied, not
computed); the render of a loaded JAX checkpoint to 1e-5 (the tolerance of
``tests/test_torch_renderer.py``'s compacted renders: other summation orders
over ≤ 32 samples a ray).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine import checkpoint as jckpt
from customnerf_tpu.engine.trainer import Trainer as JTrainer, build_encoder_spec
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine import checkpoint as tckpt
from customnerf_torch.engine.convert import params_from_flax, params_to_flax
from customnerf_torch.engine.trainer import Trainer, build_field

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import one_thread  # noqa: E402,F401

FLAGS = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
         "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
         "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
         "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01 "
         "--h 16 --w 16 --train_size 4 --update_extra_interval 2 "
         "--max_ray_batch 1000").split()
G = 16


def quiet(*_):
    pass


def _opt(tmp_path, *extra):
    return tconfig.parse_args(FLAGS + ["--workspace", str(tmp_path)] + list(extra))


def _jax_state(seed=0):
    """Flax params (numpy) and a JAX occupancy state of the FLAGS field."""
    topt = tconfig.parse_args(FLAGS)
    params = params_to_flax(build_field(topt, device="cpu").state_dict())
    rng = np.random.RandomState(seed)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    occ = jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)
    return params, occ


def _rays(n=512, seed=1):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.rand(n, 3).astype(np.float32) - 0.5) - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_jax_checkpoint_loads_in_the_port_and_renders_the_same(tmp_path):
    params, occ = _jax_state()
    path = str(tmp_path / "df_ep0003.pth")
    host_occ = jax.device_get(occ)
    jopt = jconfig.parse_args(FLAGS)
    jtx_state = {"count": np.zeros((), np.int32)}       # a JAX-only optimizer entry
    jckpt.save_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, params), 3, 30,
                          {"loss": [0.5]}, opt_state=jtx_state,
                          extra=JTrainer._occ_extra(host_occ))

    # --backend pallas: the f32 fused head, as the JAX field's f32 heads below
    tr = Trainer(_opt(tmp_path, "--backend", "pallas"), device="cpu", log=quiet,
                 use_checkpoint=path)
    assert (tr.epoch, tr.global_step, tr.n_updates) == (3, 30, 0)
    got = params_to_flax(tr.field.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr.occ_state.bitfield.numpy(), np.asarray(occ.bitfield))
    np.testing.assert_array_equal(tr.occ_state.density_grid.numpy(),
                                  np.asarray(occ.density_grid))
    assert tr.occ_state.iter_density == int(occ.iter_density)

    spec = build_encoder_spec(jopt)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    s = jren.RenderSettings(bound=2.0, num_steps=16, upsample_steps=0, soft_mask=True)
    o, d = _rays()
    want = jren.render_rays_fast(jf, jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(o), jnp.asarray(d), occ,
                                 jax.random.PRNGKey(0), s, n_coarse=32, n_keep=16,
                                 train=True, perturb=False, compact_frac=0.5,
                                 compact_block=8)
    with torch.no_grad():
        out = tr.render(torch.tensor(o), torch.tensor(d), train=True, perturb=False)
    np.testing.assert_allclose(out["image"].numpy(), np.asarray(want["image"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["render_mask"].numpy(),
                               np.asarray(want["render_mask"]), rtol=0, atol=1e-5)


def _trained(tmp_path, epochs=1, *extra):
    opt = _opt(tmp_path, *extra)
    tr = Trainer(opt, device="cpu", log=quiet, use_checkpoint="scratch")
    tr.train(NeRFDataset(opt, "train", device="cpu").dataloader(), max_epochs=epochs)
    return tr


def test_port_checkpoint_loads_in_jax(tmp_path):
    tr = _trained(tmp_path)
    path = tr.save_checkpoint()
    assert os.path.basename(path) == "df_ep0001.pth"
    params, meta = jckpt.load_checkpoint(path, opt_state_template={"x": 0})
    want = params_to_flax(tr.field.state_dict())
    flat_got = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys() and len(flat_got) == 8
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v)
    assert (meta["epoch"], meta["global_step"]) == (1, 4)
    assert "opt_state" not in meta                     # no JAX optimizer entry
    np.testing.assert_array_equal(meta["density_grid"], tr.occ_state.density_grid.numpy())
    np.testing.assert_array_equal(meta["density_bitfield"], tr.occ_state.bitfield.numpy())
    assert meta["iter_density"] == tr.occ_state.iter_density == 2
    assert meta["mean_density"] == pytest.approx(float(tr.occ_state.mean_density))
    raw = torch.load(path, weights_only=False)
    assert "params.feature_net.hidden_0.kernel" in raw["model"]
    assert raw["model"]["params.feature_net.hidden_0.kernel"].shape == (18, 64)
    assert raw[tckpt.TORCH_OPTIMIZER_KEY]["n_updates"] == 4


def test_model_only_load_restores_occupancy(tmp_path):
    tr = _trained(tmp_path / "a")
    path = tr.save_checkpoint()
    opt = _opt(tmp_path / "b", "--editing_from", path)
    fresh = Trainer(opt, device="cpu", log=quiet, use_checkpoint="scratch")
    assert (fresh.epoch, fresh.global_step, fresh.n_updates) == (0, 0, 0)
    assert not fresh.optimizer.state                     # Adam starts fresh
    assert torch.equal(fresh.occ_state.bitfield, tr.occ_state.bitfield)
    assert torch.equal(fresh.occ_state.density_grid, tr.occ_state.density_grid)
    assert fresh.occ_state.iter_density == tr.occ_state.iter_density
    for (n, a), b in zip(fresh.field.state_dict().items(), tr.field.state_dict().values()):
        assert torch.equal(a, b), n
    # latest_model: the same, from the newest file of the workspace
    lm = Trainer(_opt(tmp_path / "a"), device="cpu", log=quiet,
                 use_checkpoint="latest_model")
    assert lm.epoch == 0 and torch.equal(lm.occ_state.bitfield, tr.occ_state.bitfield)


def test_ring_latest_and_resume(tmp_path):
    tr = _trained(tmp_path, 7)
    ckpts = os.path.join(str(tmp_path), "checkpoints")
    # saved before training and twice an epoch (eval_interval 1): the
    # 5-deep ring (whose entries repeat) spares df_ep0000
    assert sorted(os.listdir(ckpts)) == [f"df_ep{e:04d}.pth" for e in (0, 6, 7)]
    assert tckpt.latest_checkpoint(ckpts).endswith("df_ep0007.pth")
    assert tr.stats["checkpoints"] == ["df_ep0005.pth", "df_ep0006.pth",
                                       "df_ep0006.pth", "df_ep0007.pth",
                                       "df_ep0007.pth"]
    back = Trainer(_opt(tmp_path), device="cpu", log=quiet, use_checkpoint="latest")
    assert (back.epoch, back.global_step, back.n_updates) == (7, 28, 28)
    for p, q in zip(back.optimizer.state.values(), tr.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(p[k], q[k])
    assert back.lr_at(back.n_updates) == tr.lr_at(tr.n_updates)
    # the JAX ring policy on the same sequence keeps the same files
    stats, d = {"checkpoints": []}, tmp_path / "jax_ring"
    os.makedirs(d)
    for name in ["df_ep0000.pth"] + [f"df_ep{e:04d}.pth" for e in range(1, 8)
                                     for _ in range(2)]:
        stats["checkpoints"].append(name)
        jckpt.prune_ring(stats, str(d), 5)
        open(d / name, "w").close()
    assert sorted(os.listdir(d)) == sorted(os.listdir(ckpts))


def test_unported_formats_name_their_roadmap_item(tmp_path):
    """``.orbax`` still raises; a reference-format (tcnn) file now loads
    through the shim (``tests/test_torch_refckpt.py`` holds it to JAX)."""
    from customnerf_torch.engine.torch_shim import export_reference_checkpoint
    from customnerf_torch.models.field import FieldConfig, NeRFField
    from customnerf_torch.ops.grid import GridSpec
    with pytest.raises(NotImplementedError, match="ROADMAP.*orbax"):
        tckpt.load_checkpoint(str(tmp_path / "df_ep0001.orbax"))
    tcnn = str(tmp_path / "ref.pth")
    field = NeRFField(FieldConfig(grid=GridSpec(num_levels=16, base_resolution=4,
                                                log2_hashmap_size=10,
                                                desired_resolution=64,
                                                gridtype="tiled")), device="cpu")
    export_reference_checkpoint(params_to_flax(field.state_dict()), tcnn, epoch=1)
    params, meta = tckpt.load_checkpoint(tcnn)
    assert meta["epoch"] == 1
    back = params_from_flax(params)
    assert back.keys() == field.state_dict().keys()
    assert all(torch.equal(v, field.state_dict()[k]) for k, v in back.items())
    with pytest.raises(NotImplementedError, match="ROADMAP.*orbax"):
        Trainer(_opt(tmp_path, "--ckpt_format", "orbax"), device="cpu", log=quiet)
