"""``--ckpt_format orbax``: checkpoint writes off the training thread
(``engine/checkpoint.py::AsyncSaver``, the JAX ``OrbaxSaver``'s
counterpart), on the CPU; the ring's entries are ``.orbax`` directories and
the best ``df.pth`` a ``.pth``.

A directory written by the worker while the trainer's state is changed in
place after ``save`` returned reloads bit for bit as the state at the save;
an asynchronous ``.pth`` holds what a synchronous save holds; the JAX
package's loader reads the directory; the ring is pruned only once no write
is pending; a failed write raises at ``wait()``; and the three saves around
one evaluation (ring, best ``df.pth``, ring) take one host snapshot between
them.
"""

import os
import time

import numpy as np
import pytest
import torch

from customnerf_tpu.engine import checkpoint as jckpt
from customnerf_torch.config import parse_args
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine import checkpoint as ckpt_io
from customnerf_torch.engine.convert import params_to_flax
from customnerf_torch.engine.trainer import Trainer
from customnerf_torch.models.field import param_names

TINY = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
        "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
        "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
        "--data_type synthetic --h 16 --w 16 --train_size 4 --iters 12 "
        "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
        "--max_steps 32 --ckpt scratch").split()


def _trainer(tmp_path, *flags):
    opt = parse_args(TINY + list(flags) + ["--workspace", str(tmp_path)])
    return Trainer(opt, device="cpu", log=lambda *_: None)


def _stepped(tmp_path, *flags, steps=2):
    tr = _trainer(tmp_path, *flags)
    loader = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
    tr.update_extra_state()
    for i in range(steps):
        tr.global_step += 1
        tr.train_step(loader.item(i))
    return tr, loader


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_async_file_reloads_bitwise_after_in_place_changes(tmp_path):
    tr, loader = _stepped(tmp_path, "--ckpt_format", "orbax")
    want = {k: v.clone() for k, v in tr.field.state_dict().items()}
    adam = {id(p): {k: v.clone() for k, v in s.items()}
            for p, s in tr.optimizer.state.items()}
    grid = tr.occ_state.density_grid.clone()
    path = tr.save_checkpoint()
    # the state moves on in place while the worker writes
    tr.global_step += 1
    tr.train_step(loader.item(2))
    tr.update_extra_state()
    with torch.no_grad():
        for p in tr.field.parameters():
            p.add_(1.0)
    tr.wait_for_saves()
    assert path.endswith("df_ep0000.orbax") and os.path.isdir(path)
    params, meta = ckpt_io.load_checkpoint(path, layout=tr.optax_layout())
    flat = ckpt_io.flatten(params)
    for k, v in ckpt_io.flatten(params_to_flax(want)).items():
        assert np.array_equal(flat[k], v), k
    assert np.array_equal(meta["density_grid"], grid.numpy())
    optim = meta[ckpt_io.TORCH_OPTIMIZER_KEY]
    assert meta["global_step"] == 2 and optim["n_updates"] == 2
    ids = [id(p) for g in tr.optimizer.param_groups for p in g["params"]]
    for i, name in enumerate(param_names(tr.field)):
        assert float(adam[ids[i]]["step"]) == float(optim["adam"]["step"]) == 2
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(optim["adam"][k][name], adam[ids[i]][k]), (name, k)
    assert not torch.equal(tr.field.grid_table, want["grid_table"])


def test_async_file_equals_a_synchronous_save(tmp_path):
    tr, _ = _stepped(tmp_path, "--ckpt_format", "orbax")
    a = tr._write(str(tmp_path / "async.pth"), full=True)
    tr.wait_for_saves()
    saver, tr.saver = tr.saver, None
    b = tr._write(str(tmp_path / "sync.pth"), full=True)
    tr.saver = saver
    da = torch.load(a, map_location="cpu", weights_only=False)
    db = torch.load(b, map_location="cpu", weights_only=False)
    assert da.keys() == db.keys() >= {"model", "torch_optimizer", "epoch", "global_step",
                                      "stats", "mean_density", "iter_density"}
    assert _tree_equal(da, db)


def test_the_jax_loader_reads_an_async_file(tmp_path):
    tr, _ = _stepped(tmp_path, "--ckpt_format", "orbax")
    path = tr.save_checkpoint()
    tr.wait_for_saves()
    params, meta = jckpt.load_checkpoint_orbax(path)
    want = ckpt_io.flatten(params_to_flax(tr.field.state_dict()))
    got = ckpt_io.flatten(params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(np.asarray(got[k]), want[k]) for k in want)
    assert meta["global_step"] == 2 and meta["epoch"] == 0
    np.testing.assert_array_equal(np.asarray(meta["density_bitfield"]),
                                  tr.occ_state.bitfield.numpy())


def test_ring_prune_waits_for_the_pending_write(tmp_path, monkeypatch):
    tr, _ = _stepped(tmp_path, "--ckpt_format", "orbax", "--max_keep_ckpt", "2")
    write, prune, seen = ckpt_io.write_checkpoint, ckpt_io.prune_ring, []

    def slow_write(path, state):
        time.sleep(0.2)
        return write(path, state)

    def spy_prune(*a, **kw):
        seen.append(tr.saver.pending)
        return prune(*a, **kw)

    monkeypatch.setattr(ckpt_io, "write_checkpoint", slow_write)
    monkeypatch.setattr(ckpt_io, "prune_ring", spy_prune)
    for epoch in range(1, 5):
        tr.epoch = epoch
        tr.save_checkpoint()
        assert tr.saver.pending
    tr.wait_for_saves()
    assert seen == [False] * 4
    assert sorted(os.listdir(tr.ckpt_path)) == ["df_ep0003.orbax", "df_ep0004.orbax"]


def test_a_failed_write_raises_at_wait(tmp_path):
    tr, _ = _stepped(tmp_path, "--ckpt_format", "orbax")
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    tr.ckpt_path = str(blocker / "checkpoints")     # cannot be created
    tr.save_checkpoint()                             # returns; the worker fails
    with pytest.raises(OSError):
        tr.wait_for_saves()
    tr.wait_for_saves()                              # the error was reported once


def test_a_file_saved_on_the_card_resumes_on_the_cpu(tmp_path):
    """On the card the optimizer is ``capturable`` with device lr tensors,
    and its state dict says so; a CPU trainer resuming from such a file
    takes its own setting back and steps on."""
    tr, loader = _stepped(tmp_path / "a")
    path = tr.save_checkpoint()
    raw = torch.load(path, map_location="cpu", weights_only=False)
    for g in raw["torch_optimizer"]["state_dict"]["param_groups"]:
        g["capturable"], g["lr"] = True, torch.tensor(float(g["lr"]))
    torch.save(raw, path)
    opt = parse_args(TINY + ["--workspace", str(tmp_path / "b")])
    back = Trainer(opt, device="cpu", log=lambda *_: None, use_checkpoint=path)
    assert back.n_updates == 2
    assert not any(g["capturable"] for g in back.optimizer.param_groups)
    back.train_step(loader.item(0))
    assert back.n_updates == 3
    assert all(float(s["step"]) == 3 for s in back.optimizer.state.values())


@pytest.mark.parametrize("fmt", ["pth", "orbax"])
def test_three_saves_around_an_evaluation_share_one_snapshot(tmp_path, monkeypatch, fmt):
    tr = _trainer(tmp_path, "--ckpt_format", fmt)
    train = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
    val = NeRFDataset(tr.opt, "val", device="cpu").dataloader()
    real, snaps = ckpt_io.snapshot, []
    monkeypatch.setattr(ckpt_io, "snapshot",
                        lambda *a, **kw: snaps.append(tr.global_step) or real(*a, **kw))
    tr.train(train, max_epochs=1, valid_loader=val)
    # one before training (step 0), one for the evaluation's three saves
    assert snaps == [0, tr.global_step] and tr.global_step == len(train)
    assert sorted(os.listdir(tr.ckpt_path)) == ["df.pth", f"df_ep0000.{fmt}",
                                                f"df_ep0001.{fmt}"]
    best = torch.load(os.path.join(tr.ckpt_path, "df.pth"), weights_only=False)
    assert "torch_optimizer" not in best
    params, meta = ckpt_io.load_checkpoint(os.path.join(tr.ckpt_path, f"df_ep0001.{fmt}"),
                                           layout=tr.optax_layout())
    model = {k: torch.from_numpy(np.asarray(v)) for k, v in ckpt_io.flatten(params).items()}
    best_params = {k: v for k, v in best["model"].items() if not k.startswith("density_")}
    assert _tree_equal(best_params, model) and "torch_optimizer" in meta
    assert meta["stats"]["results"] == tr.stats["results"]
