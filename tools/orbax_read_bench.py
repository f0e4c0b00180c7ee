"""Time the port's read and write of a flagship-size ``.orbax`` directory
against orbax's own restore and the JAX package's ``OrbaxSaver`` save, in one
process, on this machine's CPU (not the card's host).

The state is the flagship field of ``scripts/bear.sh``
(``config.FLAGSHIP_ARGS``: tri-plane 128/512 × 16/8, its MLPs) with
parameters drawn at random, the JAX trainer's optax state for it
(``engine/pytreedef.py::optax_layout``: Adam moments drawn at random, since
zeros would compress to nothing; count 3000), the occupancy grid (2
cascades of 128³) and its bitfield.  The JAX package's ``OrbaxSaver`` (what
its trainer's ``save_checkpoint`` calls under ``--ckpt_format orbax``)
writes it once for the reads.  Then, alternating, ``--repeats`` times each:
the port's ``load_checkpoint`` (parameters and meta: what a resume without
the optimizer reads), the port's read of the whole tree (the Adam state too,
as orbax restores it), orbax's ``Checkpointer(PyTreeCheckpointHandler())
.restore``; the port's ``write_orbax_tree`` of the state (uncompressed,
fsynced, committed by a rename: what ``AsyncSaver``'s worker runs) and
``OrbaxSaver.save`` of the same state through to ``wait()`` (zstd level 1,
tensorstore's writers).  Prints one JSON line with the medians and ratios.

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


def state():
    """The flagship-size state: (flax params, optax leaves, pickled treedef,
    occupancy extras), numpy arrays."""
    import numpy as np
    from customnerf_torch.config import FLAGSHIP_ARGS, parse_args
    from customnerf_torch.engine import pytreedef
    from customnerf_torch.engine.convert import params_to_flax
    from customnerf_torch.engine.trainer import build_field

    opt = parse_args(FLAGSHIP_ARGS)
    rs = np.random.RandomState(0)
    shapes = params_to_flax({k: v.detach() for k, v in
                             build_field(opt, device="cpu").state_dict().items()})

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                (rs.randn(*np.shape(v)) * 0.1).astype(np.float32) for k, v in tree.items()}

    params = draw(shapes)
    layout = pytreedef.optax_layout(pytreedef.shapes_of(params))
    leaves = pytreedef.adam_to_leaves(layout, draw(shapes), draw(shapes), 3000)
    g, cascade = opt.occ_grid_size, opt.cascade
    extra = {"density_grid": (rs.rand(cascade, g ** 3) * 20).astype(np.float32),
             "density_bitfield": rs.randint(0, 256, cascade * g ** 3 // 8).astype(np.uint8),
             "mean_density": 3.5, "mean_count": 0, "iter_density": 64}
    return params, leaves, pytreedef.dumps_treedef(list(layout.nodes)), extra


STATS = {"loss": [0.01] * 30, "checkpoints": []}


def disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--dir", default=None, help="where to write (a temporary "
                    "directory by default; deleted at the end either way)")
    args = ap.parse_args()
    import pickle

    import jax
    import orbax.checkpoint as ocp
    from customnerf_torch.engine import checkpoint as ckpt_io
    from customnerf_tpu.engine.checkpoint import OrbaxSaver

    root = os.path.abspath(args.dir or tempfile.mkdtemp())
    path = os.path.join(root, "df_ep0030.orbax")
    jax_out, port_out = (os.path.join(root, n) for n in ("jax_save.orbax", "port_save.orbax"))
    try:
        params, leaves, treedef, extra = state()
        opt_state = jax.tree_util.tree_unflatten(pickle.loads(treedef), leaves)
        saver = OrbaxSaver()

        def jax_save(where):
            saver.save(where, params, 30, 3000, STATS, opt_state=opt_state, extra=extra)
            saver.wait()

        def port_save(where):
            ckpt_io.write_orbax_tree(where, ckpt_io.orbax_state(
                params, 30, 3000, STATS, (treedef, leaves), extra))

        jax_save(path)
        disk = disk_bytes(path)
        ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler())
        runs = {"port_resume": lambda: ckpt_io.load_checkpoint(path),
                "port_whole_tree": lambda: ckpt_io.read_orbax_tree(path),
                "orbax_restore": lambda: ckptr.restore(path),
                "port_write": lambda: port_save(port_out),
                "orbax_save": lambda: jax_save(jax_out)}
        for fn in runs.values():                  # first touch: page cache, builds
            fn()
        times = {k: [] for k in runs}
        for _ in range(args.repeats):
            for name, fn in runs.items():
                t0 = time.perf_counter()
                fn()
                times[name].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        nbytes = sum(a.nbytes for a in ckpt_io.flatten(ckpt_io.read_orbax_tree(path)).values())
        print(json.dumps({
            "host": f"{os.cpu_count()} CPUs (this CPU box, not the card's host)",
            "disk_bytes": disk, "decompressed_bytes_whole_tree": nbytes,
            "port_write_disk_bytes": disk_bytes(port_out),
            "orbax_save_disk_bytes": disk_bytes(jax_out), "repeats": args.repeats,
            "median_ms": med, "ms": times,
            "port_resume_over_orbax": med["port_resume"] / med["orbax_restore"],
            "port_whole_tree_over_orbax": med["port_whole_tree"] / med["orbax_restore"],
            "port_write_over_orbax_save": med["port_write"] / med["orbax_save"],
            "port_write_mb_per_s": disk_bytes(port_out) / 1e6 / (med["port_write"] / 1e3)}))
    finally:
        for p in (path, jax_out, port_out):
            shutil.rmtree(p, ignore_errors=True)
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
