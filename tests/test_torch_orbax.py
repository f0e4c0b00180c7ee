"""Reading JAX-written ``.orbax`` checkpoints without orbax, tensorstore or
zstandard (``customnerf_torch/engine/ocdbt.py``,
``engine/checkpoint.py::load_checkpoint_orbax``).

  * The OCDBT reader lists and reads, byte for byte, what tensorstore's
    ``ocdbt`` key-value store lists and reads, on stores it writes here: a
    B+tree of height ≥ 1 (small nodes, many keys), inline and out-of-line
    values, two versions (keys overwritten and deleted), values spread over
    several data files, a manifest whose version tree has interior nodes,
    and the committed orbax fixture (its root, whose tree names files under
    ``ocdbt.process_0/``, and that sub-store).  A flipped byte in a node or
    the manifest fails its CRC-32C with ``ValueError``.
  * The committed fixture (``tools/write_orbax_fixture.py``: the JAX
    trainer's own ``save_checkpoint`` under ``--ckpt_format orbax``) loads
    bit for bit equal to its ``.npz``, its Adam state to ``_opt.npz``.
  * Directories the JAX trainer writes here — tri-plane and grid fields,
    with and without the optimizer, one re-saved over the same name — load
    equal to ``customnerf_tpu``'s ``load_checkpoint_orbax``: parameters bit
    for bit, epoch, step, stats, occupancy arrays and the Adam state equal.
  * A port trainer resumed by ``--ckpt latest`` from such a workspace renders
    what the same state renders from a ``.pth`` (rtol 1e-6) and takes the
    JAX Adam state; ``--editing_from`` a ``.orbax`` gives the ``.pth``'s pt
    image; the ring prunes ``.orbax`` directories as the JAX ring does.

``tests/test_torch_orbax_write.py`` holds the directories the port writes.
"""

import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine import checkpoint as jckpt
from customnerf_tpu.engine.trainer import Trainer as JTrainer
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine import checkpoint as tckpt
from customnerf_torch.engine import convert, editing, pytreedef
from customnerf_torch.engine.ocdbt import OcdbtStore
from customnerf_torch.engine.trainer import Trainer

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import one_thread  # noqa: E402,F401

ts = pytest.importorskip("tensorstore")

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "jax_orbax")
COMMON = ("-O --num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
          "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
          "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01 "
          "--h 16 --w 16 --train_size 4 --update_extra_interval 2 "
          "--max_ray_batch 1000 --steps_per_dispatch 1").split()
FIELDS = {
    "triplane": "--grid_type triplane --triplane_res 8 16 --triplane_channels 4 2".split(),
    "grid": ("--grid_type tiled --grid_levels 4 --grid_base_resolution 4 "
             "--log2_hashmap_size 10 --desired_resolution 32").split(),
}
G = 16


def quiet(*_):
    pass


# ------------------------------------------------------------ OCDBT stores
def _reference(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root}).result()
    return {bytes(k): bytes(kv.read(k).result().value) for k in kv.list().result()}


def _ts_write(root, transactions, **config):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root,
                          "config": config}).result()
    for writes in transactions:
        with ts.Transaction() as txn:
            for k, v in writes.items():
                if v is None:
                    kv.with_transaction(txn).delete_range(
                        ts.KvStore.KeyRange(k, k + b"\0")).result()
                else:
                    kv.with_transaction(txn).write(k, v).result()


def _values(rs, n, lo, hi, prefix=b"k"):
    return {prefix + b"%05d" % i: rs.bytes(int(rs.randint(lo, hi))) for i in range(n)}


def _store(kind, root):
    rs = np.random.RandomState(len(kind))
    if kind == "deep_tree":          # small nodes: interior levels
        _ts_write(root, [_values(rs, 300, 1, 40)], max_decoded_node_bytes=400,
                  max_inline_value_bytes=16)
    elif kind == "two_versions":     # overwrite, delete and add in a second commit
        first = _values(rs, 60, 1, 100)
        second = {k: rs.bytes(7) for k in list(first)[:10]}
        second.update({k: None for k in list(first)[10:15]})
        second.update(_values(rs, 10, 5, 50, prefix=b"z"))
        _ts_write(root, [first, second], max_inline_value_bytes=32)
    elif kind == "split_files":      # five commits, values in five or more data files
        _ts_write(root, [_values(rs, 30, 200, 2000, prefix=b"%d/" % t) for t in range(5)],
                  max_inline_value_bytes=64)
    elif kind == "version_nodes":    # 40 commits: the version tree has interior nodes
        _ts_write(root, [{b"key%02d" % t: rs.bytes(20), b"last": b"%d" % t}
                         for t in range(40)])
    else:
        src = os.path.join(FIXTURE, "df_ep0002.orbax")
        shutil.copytree(src, root)
        if kind == "orbax_process_0":
            return os.path.join(root, "ocdbt.process_0")
    return root


@pytest.mark.parametrize("kind", ["deep_tree", "two_versions", "split_files",
                                  "version_nodes", "orbax_root", "orbax_process_0"])
def test_ocdbt_reads_what_tensorstore_reads(tmp_path, kind):
    root = _store(kind, str(tmp_path / "store"))
    store = OcdbtStore(root)
    want = _reference(root)
    assert store.keys() == sorted(want)
    assert dict(store.items()) == want
    values = store._entries.values()
    if kind == "deep_tree":
        assert store.height >= 2
        assert any(isinstance(v, bytes) for v in values)          # inline
        assert any(not isinstance(v, bytes) for v in values)      # out of line
    elif kind == "two_versions":
        assert store.versions >= 2 and b"k00012" not in store
    elif kind == "split_files":           # each commit writes its own file(s)
        assert len({v[0] for v in values if not isinstance(v, bytes)}) >= 5
    elif kind == "version_nodes":
        assert store.read("last") == b"39" and store.generation > 16
    elif kind == "orbax_root":
        paths = {v[0] for v in values if not isinstance(v, bytes)}
        assert paths and all(p.startswith("ocdbt.process_0/d/") for p in paths)


def test_ocdbt_flipped_byte_fails_its_crc(tmp_path):
    root = _store("orbax_root", str(tmp_path / "store"))
    OcdbtStore(root)
    node_files = [os.path.join(root, "d", f) for f in os.listdir(os.path.join(root, "d"))]
    for path in [os.path.join(root, "manifest.ocdbt")] + node_files:
        data = bytearray(open(path, "rb").read())
        good = bytes(data)
        data[len(data) // 2] ^= 0x10
        open(path, "wb").write(bytes(data))
        with pytest.raises(ValueError, match="CRC-32C"):
            OcdbtStore(root)
        open(path, "wb").write(good)
    with pytest.raises(ValueError, match="no OCDBT manifest"):
        OcdbtStore(str(tmp_path))


# ------------------------------------------------------------------ fixture
def test_committed_fixture_equals_its_npz():
    params, meta = tckpt.load_checkpoint(os.path.join(FIXTURE, "df_ep0002.orbax"))
    want = np.load(os.path.join(FIXTURE, "df_ep0002.npz"))
    flat = tckpt.flatten(params)
    names = sorted(k[len("model."):] for k in want.files if k.startswith("model."))
    assert sorted(flat) == names and len(names) >= 8
    for k in names:
        a, b = flat[k], want["model." + k]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), k
    assert meta["stats"] == pickle.loads(want["meta.stats_pickle"].tobytes())
    assert meta["stats"]["checkpoints"] == ["df_ep0002.orbax"]
    for k in ("epoch", "global_step", "density_grid", "density_bitfield",
              "mean_density", "iter_density", "mean_count"):
        np.testing.assert_array_equal(np.asarray(meta[k]), want["meta." + k])
    assert tckpt.TORCH_OPTIMIZER_KEY not in meta          # no layout: not read
    # with the field's layout, the Adam state is the JAX restore's leaves
    layout = pytreedef.optax_layout(pytreedef.shapes_of(params))
    _, meta = tckpt.load_checkpoint(os.path.join(FIXTURE, "df_ep0002.orbax"),
                                    layout=layout)
    opt = np.load(os.path.join(FIXTURE, "df_ep0002_opt.npz"))
    leaves = [opt[f"optimizer.leaves.{i}"] for i in range(len(opt.files) - 1)]
    assert len(leaves) == len(layout.roles) == 28
    assert pytreedef.loads_treedef(opt["treedef"].tobytes()) == list(layout.nodes)
    optim = meta[tckpt.TORCH_OPTIMIZER_KEY]
    assert optim["n_updates"] == int(leaves[1]) == 8
    for (what, _, path), leaf in zip(layout.roles, leaves):
        if what in ("mu", "nu"):
            name = {"mu": "exp_avg", "nu": "exp_avg_sq"}[what]
            got = convert.params_to_flax(optim["adam"][name])
            got = dict(pytreedef._flat(got))[path]
            assert got.dtype == leaf.dtype and got.tobytes() == leaf.tobytes(), path
        elif what == "found_nan":
            assert optim["found_nan"][path] == bool(leaf)
        else:
            assert int(leaf) == optim["n_updates"]


# --------------------------------------------- directories the JAX trainer writes
def _occ(seed):
    rng = np.random.RandomState(seed)
    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    return jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)


@pytest.fixture(scope="module", params=sorted(FIELDS))
def jax_workspace(request, tmp_path_factory):
    """A JAX trainer's workspace under --ckpt_format orbax: df_ep0003.orbax
    without the optimizer, df_ep0004.orbax with it, then df_ep0004 re-saved
    over the same name with other parameters; beside it, the final state as
    a .pth.  → (kind, workspace, pth path, JAX opt)."""
    kind = request.param
    ws = str(tmp_path_factory.mktemp(f"jax_{kind}"))
    jopt = jconfig.parse_args(COMMON + FIELDS[kind] + ["--workspace", ws,
                                                       "--ckpt_format", "orbax"])
    tr = JTrainer("df", jopt, use_checkpoint="scratch")
    rs = np.random.RandomState(7)

    def perturb():
        tr.params = jax.tree_util.tree_map(
            lambda x: x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.2),
            tr.params)
        tr._host_state_cache = None

    for epoch, full, seed in ((3, False, 1), (4, True, 2), (4, True, 3)):
        perturb()
        tr.occ_state = _occ(seed)
        tr.epoch, tr.global_step = epoch, 10 * epoch + seed
        tr.stats["loss"].append(1.0 / seed)
        tr.save_checkpoint(full=full)
        tr._orbax_saver.wait()
    pth = os.path.join(str(tmp_path_factory.mktemp(f"pth_{kind}")), "df_ep0004.pth")
    host_occ = jax.device_get(tr.occ_state)
    jckpt.save_checkpoint(pth, jax.device_get(tr.params), tr.epoch, tr.global_step,
                          tr.stats, extra=JTrainer._occ_extra(host_occ))
    return kind, ws, pth, jopt


def test_orbax_loads_as_the_jax_package_loads_it(jax_workspace):
    kind, ws, _, jopt = jax_workspace
    ckpts = os.path.join(ws, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["df_ep0003.orbax", "df_ep0004.orbax"]
    for name, with_optimizer in (("df_ep0003.orbax", False), ("df_ep0004.orbax", True)):
        path = os.path.join(ckpts, name)
        got, meta = tckpt.load_checkpoint(path)
        want, jmeta = jckpt.load_checkpoint_orbax(path)
        flat_got = tckpt.flatten(got)
        flat_want = {k: np.asarray(v) for k, v in tckpt.flatten(want).items()}
        assert flat_got.keys() == flat_want.keys()
        for k, v in flat_want.items():
            assert flat_got[k].dtype == v.dtype and flat_got[k].tobytes() == v.tobytes(), k
        assert (meta["epoch"], meta["global_step"]) == (jmeta["epoch"], jmeta["global_step"])
        assert meta["stats"] == jmeta["stats"]
        for k in ("density_grid", "density_bitfield", "mean_density", "iter_density",
                  "mean_count"):
            np.testing.assert_array_equal(np.asarray(meta[k]), np.asarray(jmeta[k]))
        # with the field's layout the Adam state is the JAX restore's
        layout = pytreedef.optax_layout(pytreedef.shapes_of(got))
        _, meta = tckpt.load_checkpoint(path, layout=layout, log=quiet)
        assert (tckpt.TORCH_OPTIMIZER_KEY in meta) == with_optimizer
        if with_optimizer:
            template = JTrainer("df", jopt, use_checkpoint="scratch").opt_state
            want = convert.adam_from_optax(jax.device_get(
                jckpt.load_checkpoint_orbax(path, template)[1]["opt_state"]))
            adam = meta[tckpt.TORCH_OPTIMIZER_KEY]["adam"]
            assert torch.equal(adam["step"], want["step"])
            for k in ("exp_avg", "exp_avg_sq"):
                assert adam[k].keys() == want[k].keys()
                assert all(torch.equal(adam[k][n], want[k][n]) for n in want[k])
    # the re-save replaced the first df_ep0004: its step is the last one's
    assert tckpt.load_checkpoint(os.path.join(ckpts, "df_ep0004.orbax"))[1]["global_step"] == 43


def _port_opt(jopt, kind, ws, *extra):
    return tconfig.parse_args(COMMON + FIELDS[kind] + ["--workspace", ws] + list(extra))


def _rays(n=512, seed=1):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.rand(n, 3).astype(np.float32) - 0.5) - o
    return torch.tensor(o), torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))


def test_resume_latest_from_orbax_renders_as_the_pth(jax_workspace):
    kind, ws, pth, jopt = jax_workspace
    lines = []
    a = Trainer(_port_opt(jopt, kind, ws), device="cpu", log=lines.append,
                use_checkpoint="latest")
    b = Trainer(_port_opt(jopt, kind, ws + "_pth"), device="cpu", log=quiet,
                use_checkpoint=pth)
    assert (a.epoch, a.global_step) == (b.epoch, b.global_step) == (4, 43)
    assert a.stats == b.stats and a.n_updates == 0
    assert any("df_ep0004.orbax" in l for l in lines)
    assert "[INFO] loaded optimizer." in lines and not any("WARN" in l for l in lines)
    # the JAX trainer's Adam state (its initial one: no update was taken)
    assert len(a.optimizer.state) == len(list(a.field.parameters()))
    for st in a.optimizer.state.values():
        assert float(st["step"]) == 0
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    for (n, p), q in zip(a.field.state_dict().items(), b.field.state_dict().values()):
        assert torch.equal(p, q), n
    assert torch.equal(a.occ_state.bitfield, b.occ_state.bitfield)
    assert torch.equal(a.occ_state.density_grid, b.occ_state.density_grid)
    o, d = _rays()
    with torch.no_grad():
        ra = a.render(o, d, train=True, perturb=False)
        rb = b.render(o, d, train=True, perturb=False)
    for k in ("image", "depth", "render_mask"):
        np.testing.assert_allclose(ra[k].numpy(), rb[k].numpy(), rtol=1e-6, atol=0)


def test_editing_from_orbax_gives_the_pth_pt_image(jax_workspace, tmp_path):
    kind, ws, pth, jopt = jax_workspace
    orbax = os.path.join(ws, "checkpoints", "df_ep0004.orbax")
    pts = []
    for source in (orbax, pth):
        opt = _port_opt(jopt, kind, str(tmp_path / os.path.basename(source)),
                        "--pretrained", "--editing_from", source)
        tr = Trainer(opt, device="cpu", log=quiet, use_checkpoint="scratch")
        assert (tr.epoch, tr.global_step) == (0, 0)
        batch = next(iter(NeRFDataset(opt, "train", device="cpu").dataloader()))
        pts.append(editing._get_pt(tr, batch, torch.ones(3)))
    for k in ("pt_rgb_bg", "pt_rgb_fg", "pt_mask", "pt_depth_fg"):
        np.testing.assert_allclose(pts[0][k].numpy(), pts[1][k].numpy(), rtol=1e-6, atol=0)


def test_ring_prunes_orbax_directories_as_jax_does(tmp_path):
    """A ring of .pth files and .orbax directories (a workspace the JAX
    package started): the port removes what the JAX ring removes, sparing
    *0.pth and *0.orbax."""
    names = ["df_ep0009.orbax", "df_ep0010.orbax", "df_ep0011.pth", "df_ep0012.orbax",
             "df_ep0013.pth", "df_ep0014.orbax", "df_ep0020.pth", "df_ep0021.orbax"]
    listings = []
    for side, prune in (("port", tckpt.prune_ring), ("jax", jckpt.prune_ring)):
        d = tmp_path / side
        os.makedirs(d)
        stats = {"checkpoints": []}
        for name in names:
            stats["checkpoints"].append(name)
            prune(stats, str(d), 2)
            if name.endswith(".orbax"):
                os.makedirs(d / name / "d")
                (d / name / "manifest.ocdbt").write_bytes(b"x")
            else:
                (d / name).write_bytes(b"x")
        listings.append(sorted(os.listdir(d)))
    assert listings[0] == listings[1]
    assert "df_ep0010.orbax" in listings[0] and "df_ep0020.pth" in listings[0]
    assert "df_ep0009.orbax" not in listings[0] and "df_ep0012.orbax" not in listings[0]


def test_not_an_orbax_directory_raises_naming_it(tmp_path):
    bad = tmp_path / "df_ep0001.orbax"
    os.makedirs(bad)
    with pytest.raises(ValueError, match="df_ep0001.orbax.*_METADATA"):
        tckpt.load_checkpoint(str(bad))
