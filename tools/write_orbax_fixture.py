"""Write the JAX-written ``.orbax`` fixture the port's tests and
``chip_smoke.py`` read: ``tests/data/jax_orbax/df_ep0002.orbax/`` and the
arrays the JAX package reads back from it, ``df_ep0002.npz``.

The JAX package's own trainer writes the directory
(``customnerf_tpu.engine.trainer.Trainer.save_checkpoint`` under
``--ckpt_format orbax``, orbax's ``PyTreeCheckpointHandler``): a tiny
tri-plane field (``FLAGS``) two epochs into training on the synthetic
scene, with its Adam state and occupancy grid.  The ``.npz`` holds what the
JAX package's ``load_checkpoint_orbax`` returns: ``model.<dotted path>``
for every parameter, ``meta.epoch``, ``meta.global_step``, the occupancy
entries under ``meta.``, and ``meta.stats_pickle``.

``--opt-only`` writes just ``df_ep0002_opt.npz`` from the committed
directory, which it leaves as it is: the Adam state the JAX package's
``load_checkpoint_orbax(path, opt_state_template)`` restores from it, as
``optimizer.leaves.<i>`` (the optax state's leaves in flatten order) and
``treedef`` (``pickle.dumps`` of its treedef, uint8).

Run it where the JAX package, orbax and tensorstore are installed (never
on the card; the port does not import this file):

    JAX_PLATFORMS=cpu python tools/write_orbax_fixture.py [--opt-only] [OUT_DIR]
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLAGS = ("-O --grid_type triplane --triplane_res 16 32 --triplane_channels 8 4 "
         "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
         "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
         "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01 "
         "--h 16 --w 16 --train_size 4 --update_extra_interval 2 "
         "--max_ray_batch 1000 --steps_per_dispatch 1 --ckpt_format orbax").split()
NAME = "df_ep0002"


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def main(out_dir: str) -> None:
    import jax
    import numpy as np
    from customnerf_tpu import config as jconfig
    from customnerf_tpu.data import NeRFDataset
    from customnerf_tpu.engine import checkpoint as jckpt
    from customnerf_tpu.engine.trainer import Trainer

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as ws:
        opt = jconfig.parse_args(FLAGS + ["--workspace", ws, "--seed", "0"])
        tr = Trainer("df", opt, use_checkpoint="scratch")
        loader = NeRFDataset(opt, "train").dataloader()
        for _ in range(2):
            tr.epoch += 1
            tr.train_one_epoch(loader)
        tr.save_checkpoint(name=NAME, full=True)
        tr._orbax_saver.wait()
        src = os.path.join(tr.ckpt_path, NAME + ".orbax")
        params, meta = jckpt.load_checkpoint_orbax(src)
        arrays = {f"model.{k}": np.asarray(v) for k, v in flatten(params).items()}
        for k, v in meta.items():
            if k == "stats":
                arrays["meta.stats_pickle"] = np.frombuffer(pickle.dumps(v), np.uint8)
            elif k != "opt_state":
                arrays[f"meta.{k}"] = np.asarray(v)
        os.makedirs(out_dir, exist_ok=True)
        dst = os.path.join(out_dir, NAME + ".orbax")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        np.savez(os.path.join(out_dir, NAME + ".npz"), **arrays)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(out_dir) for f in fs)
    print(f"wrote {dst} and {NAME}.npz: {len(arrays)} arrays, {size} bytes in all")


def write_optimizer(out_dir: str) -> None:
    """``df_ep0002_opt.npz`` from ``out_dir/df_ep0002.orbax``, restored by
    the JAX package against its trainer's optax state for ``FLAGS``."""
    import jax
    import numpy as np
    from customnerf_tpu import config as jconfig
    from customnerf_tpu.engine import checkpoint as jckpt
    from customnerf_tpu.engine.trainer import Trainer

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as ws:
        opt = jconfig.parse_args(FLAGS + ["--workspace", ws, "--seed", "0"])
        template = Trainer("df", opt, use_checkpoint="scratch").opt_state
    _, meta = jckpt.load_checkpoint_orbax(os.path.join(out_dir, NAME + ".orbax"),
                                          template)
    leaves, treedef = jax.tree_util.tree_flatten(meta["opt_state"])
    arrays = {f"optimizer.leaves.{i}": np.asarray(v) for i, v in enumerate(leaves)}
    arrays["treedef"] = np.frombuffer(pickle.dumps(treedef), np.uint8)
    path = os.path.join(out_dir, NAME + "_opt.npz")
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {len(leaves)} leaves, {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--opt-only"]
    out = args[0] if args else os.path.join(REPO, "tests", "data", "jax_orbax")
    if "--opt-only" in sys.argv[1:]:
        write_optimizer(out)
    else:
        main(out)
