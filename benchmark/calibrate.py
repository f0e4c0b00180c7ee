"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 [--program]
        [--control] [--bf16] [--fault frozen|half_batch|cotangent_negated|sds_scaled]

For each seed, in one process: against the reference's first steps, the
program's (``--program``), the control's (``--control``: the reference
computed a precision lower than the configuration states: the UNet and the
VAE in bf16 with fp8 operands, the field's heads with fp8 operands, the
encoded features in bf16), the reference at the configuration's own
precision (``--bf16``), or the program's with a fault planted
(``--fault``).  The reference follows each side's own first cotangent
(``compare.py``), so it is taken again for each.  Prints one JSON line a
seed and side: the numbers ``correct`` compares, the verdict under the
cell's limits file (``correct``), and each parameter's gaps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def leaves(got: dict, ref: dict) -> dict:
    """Each parameter's first gradient against the reference's: the norms,
    the difference from the reference's backward of the side's cotangent
    (``follow``), that backward's SDS and keep_bg parts, and the
    parameter's own SDS gain."""
    out = {}
    for n, g in got["grad_vecs"].items():
        row = {"norm": float(g.norm()), "ref_norm": ref["grads"][n]}
        if "sds_vecs" in ref:
            s, b = ref["sds_vecs"][n], ref["bg_vecs"][n]
            row.update(sds_norm=float(s.norm()), bg_norm=float(b.norm()),
                       follow=float((g - s - b).norm() / max(float((s + b).norm()), 1e-30)),
                       sds_gain=float(((g - b) * s).sum() / max(float((s * s).sum()), 1e-300)))
        out[n] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--bf16", action="store_true",
                   help="the reference at the configuration's own precision: "
                        "bf16 heads, UNet and VAE")
    args = p.parse_args(argv)
    root = os.getcwd()
    from benchmark.lib import compare, registry
    from benchmark.run import cache_dirs
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])
    job = registry.job(traffic["job"])
    cache_dirs(root)
    import torch
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 3
    from benchmark.lib import training
    from benchmark.reference import nerf

    def program(fault=None):
        with training.fault(fault):
            return training.program_readings(job, cfg, traffic, seed, "cuda")

    sides = []
    if args.program:
        sides.append(("program", program))
    for name in args.fault:
        sides.append((f"fault:{name}", lambda name=name: program(name)))
    if args.control:
        low = nerf.Precision(heads="fp8", features_bf16=True)
        sides.append(("control", lambda: job.readings(cfg, traffic, seed, "cuda", low,
                                                      sd="fp8")))
    if args.bf16:
        sides.append(("reference_bf16", lambda: job.readings(
            cfg, traffic, seed, "cuda", nerf.Precision(heads="bfloat16"), sd="bfloat16")))
    for seed in args.seeds:
        for name, fn in sides:
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.empty_cache()
            ref = job.readings(cfg, traffic, seed, "cuda", follow=got)
            torch.cuda.empty_cache()
            numbers = compare.gaps(got, ref)
            print(json.dumps({"cell": cell["name"], "seed": seed, "side": name,
                              "correct": compare.judge(numbers, limits), **numbers,
                              "losses": got["losses"], "ref_losses": ref["losses"],
                              "branches": ref.get("branches"),
                              "leaves": leaves(got, ref), "change": got["change"],
                              "ref_change": ref["change"],
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
