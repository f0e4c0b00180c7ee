"""Time the port's read of a flagship-size JAX-written ``.orbax`` directory
against orbax's own restore of the same directory, in one process, on this
machine's CPU.

The directory is written by the JAX package's ``OrbaxSaver`` (what its
trainer's ``save_checkpoint`` calls under ``--ckpt_format orbax``) from the
flagship field of ``scripts/bear.sh`` (``config.FLAGSHIP_ARGS``: tri-plane
128/512 × 16/8, its MLPs): parameters drawn at random, an Adam state whose
moments are drawn at random (zeros would compress to nothing), the
occupancy grid (2 cascades of 128³) and its bitfield.  Then, alternating,
``--repeats`` times each: the port's ``load_checkpoint`` (parameters and
meta: what a resume reads), the port's read of the whole tree (the Adam
state too, as orbax restores it), and orbax's
``Checkpointer(PyTreeCheckpointHandler()).restore``.  Prints one JSON line
with the medians and the ratios.

Needs the JAX package, orbax and tensorstore (never run on the card):

    JAX_PLATFORMS=cpu python tools/orbax_read_bench.py [--repeats 5] [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def write(path: str) -> int:
    """The flagship-size directory at ``path``; returns its bytes on disk."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.engine.convert import params_to_flax
    from customnerf_torch.engine.trainer import build_field
    from customnerf_tpu.engine.checkpoint import OrbaxSaver

    opt = parse_args(FLAGSHIP_ARGS)
    rs = np.random.RandomState(0)
    shapes = params_to_flax({k: v.detach() for k, v in
                             build_field(opt, device="cpu").state_dict().items()})

    def draw(x):
        return jnp.asarray((rs.randn(*np.shape(x)) * 0.1).astype(np.float32))

    params = jax.tree_util.tree_map(draw, shapes)
    opt_state = optax.adam(1e-3).init(params)
    opt_state = jax.tree_util.tree_map(
        lambda x: draw(x) if np.ndim(x) else x, opt_state)
    g = opt.occ_grid_size
    cascade = opt.cascade
    grid = (rs.rand(cascade, g ** 3) * 20).astype(np.float32)
    extra = {"density_grid": grid,
             "density_bitfield": rs.randint(0, 256, cascade * g ** 3 // 8).astype(np.uint8),
             "mean_density": 3.5, "mean_count": 0, "iter_density": 64}
    saver = OrbaxSaver()
    saver.save(path, params, 30, 3000, {"loss": [0.01] * 30, "checkpoints": []},
               opt_state=opt_state, extra=extra)
    saver.wait()
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--dir", default=None, help="where to write (a temporary "
                    "directory by default; deleted at the end either way)")
    args = ap.parse_args()
    import orbax.checkpoint as ocp
    from customnerf_torch.engine import checkpoint as ckpt_io

    root = args.dir or tempfile.mkdtemp()
    path = os.path.join(os.path.abspath(root), "df_ep0030.orbax")
    try:
        disk = write(path)
        ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler())
        runs = {"port_resume": lambda: ckpt_io.load_checkpoint(path),
                "port_whole_tree": lambda: ckpt_io.read_orbax_tree(path, skip=()),
                "orbax_restore": lambda: ckptr.restore(path)}
        for fn in runs.values():                  # first touch: page cache, builds
            fn()
        times = {k: [] for k in runs}
        for _ in range(args.repeats):
            for name, fn in runs.items():
                t0 = time.perf_counter()
                fn()
                times[name].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        tree, _ = ckpt_io.read_orbax_tree(path, skip=())
        nbytes = sum(a.nbytes for a in ckpt_io.flatten(tree).values())
        print(json.dumps({
            "host": f"{os.cpu_count()} CPUs", "disk_bytes": disk,
            "decompressed_bytes_whole_tree": nbytes, "repeats": args.repeats,
            "median_ms": med, "ms": times,
            "port_resume_over_orbax": med["port_resume"] / med["orbax_restore"],
            "port_whole_tree_over_orbax": med["port_whole_tree"] / med["orbax_restore"]}))
    finally:
        shutil.rmtree(path, ignore_errors=True)
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
