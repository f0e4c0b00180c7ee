"""Reference-format (torch-ngp / tcnn) checkpoints: the port's
``engine/torch_shim.py`` against the JAX package's, both ways, for the
fused rgb head and both split ``RGB_network`` layouts, with one and two conf
channels; and a reference file loaded through ``--ckpt`` and
``--editing_from`` renders what the JAX field renders from it.

Tolerances: the packing moves f32 values without arithmetic, so trees are
compared exactly; renders rtol 1e-5, atol 1e-6 (``test_torch_dense.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.engine import checkpoint as jckpt
from customnerf_tpu.engine import torch_shim as jshim
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import grid as jgrid
from customnerf_torch.config import parse_args
from customnerf_torch.engine import checkpoint as tckpt
from customnerf_torch.engine import convert
from customnerf_torch.engine import torch_shim as tshim
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.models import field as tfield
from customnerf_torch.ops import grid as tgrid

# the reference's 16 levels × 2 channels (a 32-wide feature, as the tcnn
# layout assumes) on small tables
GRID = dict(num_levels=16, level_dim=2, base_resolution=4, log2_hashmap_size=10,
            desired_resolution=64, gridtype="tiled")
GRID_FLAGS = ("--grid_type tiled --grid_levels 16 --grid_level_dim 2 "
              "--grid_base_resolution 4 --log2_hashmap_size 10 "
              "--desired_resolution 64").split()
VARIANTS = {"fused": {}, "detach_mask": {"detach_mask_from_field": True},
            "mask_no_dir": {"mask_no_dir": True}, "fused_conf2": {"conf_channels": 2},
            "detach_mask_conf2": {"detach_mask_from_field": True, "conf_channels": 2}}
quiet = lambda *_: None                                        # noqa: E731


def _tree(variant, seed=0):
    """A flax-layout tree of a port field of the variant, with a table of
    O(1) entries."""
    f = tfield.NeRFField(tfield.FieldConfig(grid=tgrid.GridSpec(**GRID),
                                            **VARIANTS[variant]), seed=seed, device="cpu")
    tree = convert.params_to_flax(f.state_dict())
    rng = np.random.RandomState(seed)
    tree["params"]["grid_table"] = rng.randn(
        *tree["params"]["grid_table"].shape).astype(np.float32)
    return tree


def _assert_trees_equal(a, b):
    la = dict(jax.tree_util.tree_leaves_with_path(a))
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert la.keys() == lb.keys()
    for k, v in la.items():
        np.testing.assert_array_equal(np.asarray(lb[k]), np.asarray(v),
                                      err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_export_imports_into_the_port_as_into_jax(tmp_path, variant):
    tree = _tree(variant)
    conf = VARIANTS[variant].get("conf_channels", 1)
    path = str(tmp_path / "ref.pth")
    jshim.export_reference_checkpoint(tree, path, epoch=3, global_step=30)
    want = jax.tree_util.tree_map(np.asarray,
                                  jshim.import_reference_checkpoint(path, conf_channels=conf))
    got = tshim.import_reference_checkpoint(path, conf_channels=conf)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, tree)          # and the field round-trips


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_export_imports_into_jax(tmp_path, variant):
    tree = _tree(variant, seed=1)
    conf = VARIANTS[variant].get("conf_channels", 1)
    ours, theirs = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    tshim.export_reference_checkpoint(tree, ours, epoch=2, global_step=9)
    jshim.export_reference_checkpoint(tree, theirs, epoch=2, global_step=9)
    got = jax.tree_util.tree_map(np.asarray,
                                 jshim.import_reference_checkpoint(ours, conf_channels=conf))
    _assert_trees_equal(got, tree)
    a = torch.load(ours, map_location="cpu", weights_only=False)
    b = torch.load(theirs, map_location="cpu", weights_only=False)
    assert a.keys() == b.keys() and a["model"].keys() == b["model"].keys()
    for k, v in b["model"].items():
        assert a["model"][k].dtype == v.dtype and torch.equal(a["model"][k], v), k
    split = "conf_net" in tree["params"]
    assert ("rgb_network.conf_network.params" in a["model"]) == split


def test_load_checkpoint_routes_reference_files_through_the_shim(tmp_path):
    tree = _tree("fused")
    path = str(tmp_path / "ref.pth")
    tshim.export_reference_checkpoint(tree, path, epoch=7, global_step=70)
    params, meta = tckpt.load_checkpoint(path)
    jparams, jmeta = jckpt.load_checkpoint(path)
    _assert_trees_equal(params, jax.tree_util.tree_map(np.asarray, jparams))
    assert meta["epoch"] == jmeta["epoch"] == 7 and meta["global_step"] == 70
    # an occupancy grid stored as model buffers leaves the tree for meta
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    ckpt["model"]["density_grid"] = torch.ones(2, 8)
    torch.save(ckpt, path)
    params, meta = tckpt.load_checkpoint(path)
    assert "density_grid" not in params["params"] and meta["density_grid"].shape == (2, 8)


def _rays(n=40, seed=2):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.rand(n, 3).astype(np.float32) - 0.5) - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("how", ["ckpt", "editing_from"])
def test_reference_file_drives_the_trainer_as_it_drives_jax(tmp_path, how):
    """``--ckpt <ref.pth>`` and ``--pretrained --editing_from <ref.pth>``
    on ``-O2``: the loaded field renders what the JAX field renders from
    the JAX package's import of the same file."""
    tree = _tree("fused", seed=3)
    path = str(tmp_path / "ref.pth")
    jshim.export_reference_checkpoint(tree, path)
    # --backend pallas: the f32 fused head, as the JAX field's f32 heads below
    flags = ["-O2", *GRID_FLAGS, "--num_steps", "8", "--upsample_steps", "8",
             "--bound", "2", "--data_type", "synthetic", "--soft_mask",
             "--backend", "pallas", "--workspace", str(tmp_path / "ws")]
    if how == "ckpt":
        tr = Trainer(parse_args(flags), device="cpu", log=quiet, use_checkpoint=path)
        field = tr.field
    else:
        opt = parse_args(flags + ["--pretrained", "--editing_from", path,
                                  "--ckpt", "scratch"])
        tr = Trainer(opt, device="cpu", log=quiet, use_checkpoint="scratch")
        field = tr.field_pretrained
        assert field is not tr.field
        assert torch.equal(tr.field.grid_table, field.grid_table)
    assert tr.occ_state is None
    o, d = _rays()
    out = tr.render_image(torch.tensor(o), torch.tensor(d), field=field)

    jparams, _ = jckpt.load_checkpoint(path)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=jgrid.GridSpec(**GRID),
                                             compute_dtype="float32"))
    s = jren.RenderSettings(bound=2.0, num_steps=8, upsample_steps=8, soft_mask=True)
    want = jax.jit(lambda p: jren.render_rays(
        jf, p, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0), s,
        train=False, perturb=False))(jax.tree_util.tree_map(jnp.asarray, jparams))
    for k in ("image", "depth", "weights_sum", "render_mask"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for side in ("fg", "bg"):
        np.testing.assert_allclose(out[side]["image"].numpy(),
                                   np.asarray(want[side]["image"]), rtol=1e-5, atol=1e-6)
