""".orbax checkpoints both ways: the JAX Adam state restored from JAX-written
directories, and the directories the port writes under ``--ckpt_format
orbax`` (``customnerf_torch/engine/pytreedef.py``, ``engine/ocdbt.py::
write_store``, ``engine/checkpoint.py::write_orbax_tree``), held to the JAX
package, orbax and tensorstore on the CPU.

  * The port's Adam from the committed fixture equals ``adam_from_optax`` of
    the JAX ``load_checkpoint_orbax(path, template)`` bit for bit.
  * A port-written directory: tensorstore lists and reads its store, orbax's
    own restore reads it, and the JAX ``load_checkpoint_orbax`` restores
    parameters, meta, occupancy and an ``opt_state`` whose structure is
    ``tree_structure(tx.init(params))`` and whose leaves are
    ``adam_to_optax(...)`` bit for bit, without a warning; with and without
    ``--weight_decay``.
  * JAX → port → JAX: the fixture resumed by the port and written again
    restores in JAX bit for bit as the fixture does.
  * A JAX trainer and a port trainer resumed from the same directory take
    one step on the same batch (``perturb=False``, the f32 field of
    ``tests/test_torch_trainer.py``); their parameters agree within that
    test's Adam-step tolerance: 1e-4 of the group's lr where the gradient is
    above 1e-3 of its leaf's largest, 2·lr elsewhere.
  * The restricted unpickler refuses other names with ``ValueError`` and
    never calls them; a mismatched treedef or leaf warns as the JAX loader
    does and leaves a fresh Adam; a temporary directory is never ``latest``
    and a failed write leaves none behind, raises at ``wait()`` and writes
    no ``.pth``; the ring prunes port-written directories as the JAX ring.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine import checkpoint as jckpt
from customnerf_tpu.engine.trainer import Trainer as JTrainer
from customnerf_tpu.engine.trainer import build_encoder_spec
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import NeRFDataset, RayBatch
from customnerf_torch.engine import checkpoint as tckpt
from customnerf_torch.engine import convert, ocdbt, pytreedef
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.models.field import param_names

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
from test_torch_guidance import one_thread  # noqa: E402,F401
from test_torch_trainer import _batch, f32_field  # noqa: E402
from write_orbax_fixture import FLAGS as FIXTURE_FLAGS  # noqa: E402

ts = pytest.importorskip("tensorstore")
ocp = pytest.importorskip("orbax.checkpoint")

FIXTURE = os.path.join(HERE, "data", "jax_orbax", "df_ep0002.orbax")
TINY = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
        "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
        "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
        "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01 "
        "--h 16 --w 16 --train_size 4 --update_extra_interval 2 "
        "--max_ray_batch 1000 --steps_per_dispatch 1 --ckpt_format orbax").split()


def quiet(*_):
    pass


def _flags(base, ws, *extra):
    return [f for f in base if f not in ("--ckpt_format", "orbax")] + [
        "--ckpt_format", "orbax", "--workspace", str(ws)] + list(extra)


def _port(base, ws, *extra, use_checkpoint="scratch", log=quiet, field=None):
    opt = tconfig.parse_args(_flags(base, ws, *extra))
    return Trainer(opt, field=field, device="cpu", log=log, use_checkpoint=use_checkpoint)


def _jax(base, ws, *extra, use_checkpoint="scratch"):
    opt = jconfig.parse_args(_flags(base, ws, *extra))
    return JTrainer("df", opt, use_checkpoint=use_checkpoint)


def _stepped(ws, *extra, steps=3):
    """A port trainer after ``steps`` updates (non-zero Adam moments)."""
    tr = _port(TINY, ws, *extra)
    loader = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
    tr.update_extra_state()
    for i in range(steps):
        tr.global_step += 1
        tr.train_step(loader.item(i % len(loader)))
    tr.epoch = 3
    return tr


def _port_adam(tr):
    sd = tr.optimizer.state_dict()
    adam = convert.adam_from_torch(sd, param_names(tr.field), tr.field.state_dict())
    adam["step"] = torch.tensor(float(tr.n_updates))
    return adam


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert x.tobytes() == y.tobytes(), i


def _flat(tree):
    return {k: np.asarray(v) for k, v in tckpt.flatten(tree).items()}


# ------------------------------------------------------------ JAX → port
def test_fixture_adam_equals_the_jax_restore(tmp_path):
    jt = _jax(FIXTURE_FLAGS, tmp_path / "j")
    _, jmeta = jckpt.load_checkpoint_orbax(FIXTURE, jt.opt_state)
    want = convert.adam_from_optax(jax.device_get(jmeta["opt_state"]))
    lines = []
    tr = _port(FIXTURE_FLAGS, tmp_path / "t", use_checkpoint=FIXTURE, log=lines.append)
    assert "[INFO] loaded optimizer." in lines and not any("WARN" in l for l in lines)
    assert tr.n_updates == int(want["step"]) == 8 and tr.global_step == jmeta["global_step"]
    got = _port_adam(tr)
    for k in ("exp_avg", "exp_avg_sq"):
        assert got[k].keys() == want[k].keys()
        for n, v in want[k].items():
            assert got[k][n].dtype == v.dtype and torch.equal(got[k][n], v), (k, n)
    assert all(float(s["step"]) == 8 for s in tr.optimizer.state.values())
    assert tr.lr_at(tr.n_updates) == pytest.approx(float(jt.lr_fn(8)), rel=1e-6)


# ------------------------------------------------------------ port → JAX
def test_write_store_reads_back_in_tensorstore(tmp_path):
    rs = np.random.RandomState(3)
    entries = {f"k{i:03d}/{'x' * (i % 7)}": rs.bytes(int(rs.randint(0, 3000)))
               for i in range(120)}
    root = str(tmp_path / "store")
    n = ocdbt.write_store(root, entries)
    assert n == sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(root) for f in fs)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root}).result()
    got = {bytes(k): bytes(kv.read(k).result().value) for k in kv.list().result()}
    assert got == {k.encode(): v for k, v in entries.items()}
    store = ocdbt.OcdbtStore(root)
    assert dict(store.items()) == got
    kinds = {isinstance(v, bytes) for v in store._entries.values()}
    assert kinds == {True, False}              # inline and out of line


@pytest.mark.parametrize("weight_decay", ["0", "0.1"])
def test_port_directory_restores_in_orbax_and_jax(tmp_path, capsys, weight_decay):
    tr = _stepped(tmp_path / "t", "--weight_decay", weight_decay)
    tr._found_nan = {"params.grid_table": True}        # carried as read
    path = tr.save_checkpoint()
    tr.wait_for_saves()
    assert path.endswith("df_ep0003.orbax") and os.path.isdir(path)
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "d",
                                        "manifest.ocdbt"]
    # orbax's own restore
    restored = ocp.Checkpointer(ocp.PyTreeCheckpointHandler()).restore(path)
    assert restored["meta"]["epoch"] == 3 and restored["meta"]["global_step"] == 3
    mine = tckpt.read_orbax_tree(path)
    _leaves_equal(restored["optimizer"], mine["optimizer"])
    _leaves_equal(restored["model"], mine["model"])
    # the JAX package's loader, against its trainer's template
    jt = _jax(TINY, tmp_path / "j", "--weight_decay", weight_decay)
    capsys.readouterr()
    params, meta = jckpt.load_checkpoint_orbax(path, jt.opt_state)
    assert "WARN" not in capsys.readouterr().out
    want = _flat(convert.params_to_flax(tr.field.state_dict()))
    got = _flat(params)
    assert got.keys() == want.keys()
    assert all(got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
               for k in want)
    assert (meta["epoch"], meta["global_step"]) == (3, 3) and meta["stats"] == tr.stats
    np.testing.assert_array_equal(meta["density_grid"], tr.occ_state.density_grid.numpy())
    np.testing.assert_array_equal(meta["density_bitfield"], tr.occ_state.bitfield.numpy())
    assert meta["mean_density"] == float(tr.occ_state.mean_density)
    assert meta["iter_density"] == tr.occ_state.iter_density
    tmpl = jt.tx.init(jt.params)
    assert jax.tree_util.tree_structure(meta["opt_state"]) == \
        jax.tree_util.tree_structure(tmpl)
    expect = jax.tree_util.tree_leaves(
        convert.adam_to_optax(_port_adam(tr), jax.device_get(tmpl)))
    expect[0] = np.array(True)           # the grid label's found_nan of grid_table
    _leaves_equal(meta["opt_state"], expect)


def test_jax_port_jax_round_trip_is_bit_for_bit(tmp_path):
    tr = _port(FIXTURE_FLAGS, tmp_path / "t", use_checkpoint=FIXTURE)
    path = str(tmp_path / "t" / "checkpoints" / "df_ep0002.orbax")
    tr._write(path, full=True)
    tr.wait_for_saves()
    template = _jax(FIXTURE_FLAGS, tmp_path / "j").opt_state
    p0, m0 = jckpt.load_checkpoint_orbax(FIXTURE, template)
    p1, m1 = jckpt.load_checkpoint_orbax(path, template)
    _leaves_equal(p0, p1)
    assert m0.keys() == m1.keys()
    assert jax.tree_util.tree_structure(m0["opt_state"]) == \
        jax.tree_util.tree_structure(m1["opt_state"])
    _leaves_equal(m0["opt_state"], m1["opt_state"])
    assert m0["stats"] == m1["stats"]
    for k in ("epoch", "global_step", "density_grid", "density_bitfield",
              "mean_density", "iter_density", "mean_count"):
        a, b = np.asarray(m0[k]), np.asarray(m1[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    # the treedef's bytes differ (the port memoizes classes, not strings);
    # what they unpickle to does not
    t0 = tckpt.read_orbax_tree(FIXTURE)["optimizer"]["treedef"].tobytes()
    t1 = tckpt.read_orbax_tree(path)["optimizer"]["treedef"].tobytes()
    assert pickle.loads(t0) == pickle.loads(t1)


def test_jax_and_port_trainers_take_the_same_step_after_resume(tmp_path):
    """Both trainers resume from one port-written directory (3 updates in)
    and take one step on the same 2048 rays with the f32 field."""
    src = _stepped(tmp_path / "src")
    path = src.save_checkpoint()
    src.wait_for_saves()
    # the JAX trainer resumed; its step from its own tx and an f32 field
    jt = _jax(TINY, tmp_path / "j", use_checkpoint=path)
    assert jt.global_step == 3
    spec = dataclasses.replace(build_encoder_spec(jt.opt), mm_bf16=False)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    o, d, rgb, mask = _batch(2048, 1)
    s = jren.RenderSettings(bound=2.0, num_steps=16, upsample_steps=0, soft_mask=True)

    def loss_fn(p):
        out = jren.render_rays_fast(
            jf, p, jnp.asarray(o), jnp.asarray(d), jt.occ_state,
            jax.random.PRNGKey(0), s, n_coarse=32, n_keep=16, train=True,
            perturb=False, compact_frac=0.5, compact_block=8)
        return (jt.opt.train_rgb * jnp.mean((out["image"] - rgb) ** 2)
                + jt.opt.train_conf * jnp.mean((out["render_mask"][..., 0] - mask) ** 2))

    jgrads = jax.jit(jax.grad(loss_fn))(jt.params)
    updates, _ = jt.tx.update(jgrads, jt.opt_state, jt.params)
    jnew = _flat(jax.device_get(jax.tree_util.tree_map(lambda a, b: a + b,
                                                       jt.params, updates)))
    jg = _flat(jax.device_get(jgrads))
    # the port trainer resumed from the same directory, with the f32 field
    opt = tconfig.parse_args(_flags(TINY, tmp_path / "t"))
    tt = Trainer(opt, field=f32_field(opt), device="cpu", log=quiet, use_checkpoint=path)
    assert tt.n_updates == 3
    p0 = _flat(convert.params_to_flax(tt.field.state_dict()))
    batch = RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                     rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=32, W=64,
                     img_path="parity", index=0)
    tt.train_step(batch, perturb=False)
    tnew = _flat(convert.params_to_flax(tt.field.state_dict()))
    lr = tt.lr_at(3)
    assert jnew.keys() == tnew.keys() == jg.keys()
    for k in jnew:
        lr_g = lr * (10.0 if "grid_table" in k else 1.0)
        dj, dt = jnew[k] - p0[k], tnew[k] - p0[k]
        sure = np.abs(jg[k]) > 1e-3 * np.abs(jg[k]).max()
        assert sure.mean() > 0.05, k
        np.testing.assert_allclose(dt[sure], dj[sure], rtol=0, atol=1e-4 * lr_g, err_msg=k)
        assert np.abs(dt - dj).max() <= 2.0 * lr_g * (1 + 1e-4), k


# ----------------------------------------------------------------- failures
class _Evil:
    def __init__(self, target):
        self.target = target

    def __reduce__(self):
        return os.system, (f"touch {self.target}",)


def test_restricted_unpickler_refuses_other_names(tmp_path):
    target = tmp_path / "pwned"
    with pytest.raises(ValueError, match="system"):
        pytreedef.loads_treedef(pickle.dumps(_Evil(target)))
    assert not target.exists()
    # a name beside the accepted ones, in an otherwise well-formed treedef
    good = pytreedef.dumps_treedef(list(pytreedef.optax_layout(
        {"params.grid_table": (4, 2)}).nodes))
    bad = good.replace(b"ScaleByAdamState", b"ScaleByLionState")
    with pytest.raises(ValueError, match="ScaleByLionState"):
        pytreedef.loads_treedef(bad)
    with pytest.raises(ValueError, match="not a readable pickle"):
        pytreedef.loads_treedef(good[:len(good) // 2])


@pytest.mark.parametrize("fault", ["weight_decay", "leaf_dtype"])
def test_mismatched_optimizer_warns_and_keeps_a_fresh_adam(tmp_path, fault):
    tr = _stepped(tmp_path / "t", "--weight_decay", "0.1" if fault == "weight_decay" else "0")
    path = tr.save_checkpoint()
    tr.wait_for_saves()
    if fault == "leaf_dtype":
        tree = tckpt.read_orbax_tree(path)
        tree["optimizer"]["leaves"]["2"] = tree["optimizer"]["leaves"]["2"].astype(np.float64)
        for k in ("epoch", "global_step", "iter_density", "mean_count"):
            tree["meta"][k] = int(tree["meta"][k])
        tree["meta"]["mean_density"] = float(tree["meta"]["mean_density"])
        tckpt.write_orbax_tree(path, tree)
    lines = []
    back = _port(TINY, tmp_path / "t", use_checkpoint="latest", log=lines.append)
    warns = [l for l in lines if l.startswith("[WARN] failed to restore orbax optimizer "
                                              f"state: {path}")]
    assert len(warns) == 1 and "loaded optimizer" not in " ".join(lines)
    assert back.n_updates == 0 and not back.optimizer.state
    assert back.global_step == 3                  # the rest of the resume stands
    assert all(torch.equal(p, q) for p, q in zip(back.field.parameters(),
                                                 tr.field.parameters()))


def test_a_temporary_directory_is_never_latest(tmp_path, monkeypatch):
    tr = _stepped(tmp_path / "t")
    path = tr.save_checkpoint()
    tr.wait_for_saves()
    ckpts = tr.ckpt_path
    os.makedirs(os.path.join(ckpts, "df_ep0009.orbax.orbax-checkpoint-tmp-1"))
    assert tckpt.latest_checkpoint(ckpts) == jckpt.latest_checkpoint(ckpts) == path

    def broken(*a, **kw):
        raise OSError("disk full")

    # a failed write: raises at wait(), keeps the old directory, leaves no
    # temporary one and writes no .pth in its place
    before = tckpt.read_orbax_tree(path)
    monkeypatch.setattr(tckpt, "write_store", broken)
    tr.global_step += 5
    tr.save_checkpoint()                          # the same name: df_ep0003
    with pytest.raises(OSError, match="disk full"):
        tr.wait_for_saves()
    assert sorted(os.listdir(ckpts)) == ["df_ep0003.orbax", "df_ep0009.orbax.orbax-checkpoint-tmp-1"]
    _leaves_equal(before, tckpt.read_orbax_tree(path))


def test_ring_prunes_port_directories_as_jax_does(tmp_path):
    tr = _stepped(tmp_path / "t", "--max_keep_ckpt", "2")
    stats, jdir = {"checkpoints": []}, tmp_path / "jax_ring"
    os.makedirs(jdir)
    for epoch in (1, 2, 3, 10, 11, 12):
        tr.epoch = epoch
        tr.save_checkpoint()
        name = f"df_ep{epoch:04d}.orbax"
        stats["checkpoints"].append(name)
        jckpt.prune_ring(stats, str(jdir), 2)
        os.makedirs(jdir / name)
    tr.wait_for_saves()
    assert sorted(os.listdir(tr.ckpt_path)) == sorted(os.listdir(jdir)) == [
        "df_ep0010.orbax", "df_ep0011.orbax", "df_ep0012.orbax"]
    assert tckpt.latest_checkpoint(tr.ckpt_path).endswith("df_ep0012.orbax")
