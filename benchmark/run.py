"""The benchmark of the PyTorch/CUDA port, ``customnerf_torch``, on one
NVIDIA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``'s ``workloads``: a configuration (``configs/``) under a
traffic mix (``traffic/``), whose ``job`` names the module that drives it
(``jobs/``).  ``--trace 0`` times the window and reports the
cell's end-to-end metrics; ``--trace 1`` traces an epoch and reports its
per-layer metrics (``metrics/``) with a breakdown.  Either way the first
steps are held against the plain reference (``reference/``) once the
program's state is freed, and the numbers compared are printed beside
their limits (``limits/``), on standard error and under ``compared``.
The last line of standard output is the result as one JSON object.

Exits 3, with no result, without a CUDA card (or with fewer than the cell
needs), and 4 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "customnerf_tpu")


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths: the
    port builds its kernels into ``build/`` itself."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()

    from benchmark.lib import compare, registry
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"])
    cache_dirs(root)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"[benchmark] needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 3
    from benchmark.lib import training
    result, numbers, limits = training.run(registry.job(traffic["job"]), cell, bench, cfg,
                                           traffic, args.seed, args.seconds,
                                           bool(args.trace), T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"[benchmark] loaded in this process: {bad}", file=sys.stderr)
        return 4
    result["compared"] = compare.compared(numbers, limits)
    for line in compare.lines(numbers, limits):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
