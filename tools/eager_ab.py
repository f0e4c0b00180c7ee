"""The eager rows of ``chip_smoke.py``'s step table for two checkouts on
one card, alternated in fresh processes, without the fixture writers and
the other phases that ``chip_smoke.py`` runs beside them.

    python3 tools/eager_ab.py DIR_A DIR_B [--pairs N] [--out OUT]

DIR_A and DIR_B each hold a whole checkout (e.g. two commits' ``git
archive``s unpacked under ``build/``).  Pair i runs A then B when i is
even, B then A when it is odd.  Each run is one process in that checkout
that calls the checkout's own ``chip_smoke.py`` phases in its order: the
main path (40 eager flagship steps with K1-f32), the 4 steps with
``mm_bf16`` off, the checkpoint, the flagship's dispatch check (24 eager
steps against K = 8 replays, then the sync and async saves), and the
editing phase (8 eager steps with the tracer's stage times, then its
dispatch check).
Each run's numbers go to OUT/<a|b><n>.json (OUT defaults to
``chiprun_out/eager_ab``), and a summary of medians by side to stdout.
Needs the card."""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time


def one(checkout: str, out: str) -> None:
    """One run in ``checkout`` (the process's working directory)."""
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False        # as chip_smoke.py sets them
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from customnerf_torch.engine.measure import captured_calls, card_line
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.ops import kernels

    kernels.build()
    kernels.library()
    try:
        with captured_calls(Trainer, "train_step", keep=1) as last_step:
            tr, _, _ = cs.run_trainer()
        recon = last_step[-1][0][0]
        cs.run_f32_dtable_steps(recon)
        editor, edit_opt, ck = cs.run_checkpoint(recon)
        disp, _ = cs.run_flagship_dispatch(ck["checkpoint"])
        del recon
        ed, _, _ = cs.run_editing(editor, edit_opt)
    finally:
        shutil.rmtree(cs.RECON_WORKSPACE, ignore_errors=True)
    res = {
        "card": card_line(),
        "flagship_k1_f32_ms": tr["steady_ms_per_step"],
        "flagship_eager_ms": disp["median_eager_ms"],
        "flagship_graph_ms": disp["median_graph_ms"],
        "flagship_step_span_ms": disp.get("step_span_ms"),     # None before the tracer
        "save_sync_ms": disp["checkpoint"]["sync_block_ms"],
        "save_async_ms": disp["checkpoint"]["async_block_ms"],
        "editing_eager_ms": ed["dispatch"]["median_eager_ms"],
        "editing_graph_ms": ed["dispatch"]["median_graph_ms"],
        "editing_step_span_ms": ed["dispatch"].get("step_span_ms"),
        "editing_marked_ms": ed["median_ms"]["total"],
        "editing_marked_pt_cached_ms": ed["median_ms_pt_cached"],
    }
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(os.path.abspath(sys.argv[2]), os.path.abspath(sys.argv[3]))
        return 0
    args = sys.argv[1:]
    pairs, out = 4, os.path.join("chiprun_out", "eager_ab")
    if "--pairs" in args:
        i = args.index("--pairs")
        pairs = int(args.pop(i + 1))
        args.pop(i)
    if "--out" in args:
        i = args.index("--out")
        out = args.pop(i + 1)
        args.pop(i)
    dirs = {"a": os.path.abspath(args[0]), "b": os.path.abspath(args[1])}
    os.makedirs(out, exist_ok=True)
    out = os.path.abspath(out)
    runs, n, rc = {"a": [], "b": []}, 0, 0
    for p in range(pairs):
        for side in ("ab" if p % 2 == 0 else "ba"):
            n += 1
            path = os.path.join(out, f"{side}{n}.json")
            t0 = time.time()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                                   dirs[side], path], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            with open(os.path.join(out, f"{side}{n}.log"), "w") as f:
                f.write(proc.stdout)
            print(f"{side}{n}: {dirs[side]} exit {proc.returncode} in "
                  f"{time.time() - t0:.0f} s", flush=True)
            if proc.returncode:
                rc = 1
                continue
            with open(path) as f:
                runs[side].append(json.load(f))
    for key in (runs["a"] or runs["b"] or [{}])[0]:
        if key == "card":
            continue
        vals = {s: [r[key] for r in runs[s]] for s in "ab"}
        print(key, " | ".join(
            f"{s}: median {statistics.median(v):.3f} of {[round(x, 3) for x in v]}"
            for s, v in vals.items() if v))
    return rc


if __name__ == "__main__":
    sys.exit(main())
