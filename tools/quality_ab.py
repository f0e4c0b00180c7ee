"""Variants of ``scripts/bear.sh`` phase 1 on the bear fixture, on the card,
with per-epoch diagnostics: the eval PSNR, the mean training losses, the
compaction's slab fill and overflowing-block share, and the occupancy
grid's mean density and occupied share at each refresh.

    python -m tools.quality_ab [VARIANT ...]

Each VARIANT is one quoted string of extra flags for ``bear.sh`` phase 1
(``""`` is the recipe as it stands), optionally with one of two words that
swap a piece of the field for a study:

* ``PLAIN``: the fused-MLP and table-gradient kernels' plain PyTorch
  versions instead of the kernels;
* ``BF16``: the heads in bfloat16 (the JAX package's ``-O`` policy for its
  flax heads), plain PyTorch.

e.g. ``python -m tools.quality_ab "" "--seed 1" "--compact_frac 0" PLAIN``.
The fixture is written as ``chip_smoke.py`` writes it, into
``build/quality/`` (deleted at the end); the last strips of each run go to
``chiprun_out/quality_ab/``.  Needs the card.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import time


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("quality_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from customnerf_torch.__main__ import main as cli
    from customnerf_torch.engine.measure import card_line
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.models import field
    from customnerf_torch.ops import fused_mlp, kernels, triplane, triplane_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    variants = (argv if argv is not None else sys.argv[1:]) or [""]
    procs = cs.start_fixtures()
    try:
        kernels.build()
        kernels.library()
        path = cs.wait_fixture(procs["nerfstudio"], "nerfstudio")
    finally:
        for p in procs.values():
            p.kill()
            p.wait()

    steps, refreshes = [], []
    train_step, update = Trainer.train_step, Trainer.update_extra_state

    def step(self, *a, **kw):
        out = train_step(self, *a, **kw)
        aux, stats = out[1], out[2]
        steps.append((float(aux["loss_c"]), float(aux.get("loss_m", 0.0)),
                      float(stats.get("slab_fill", -1)),
                      float(stats.get("overflow_frac", -1))))
        return out

    def refresh(self):
        update(self)
        o = self.occ_state
        thresh = min(float(o.mean_density), self.opt.density_thresh)
        refreshes.append((float(o.mean_density),
                          float((o.density_grid > thresh).float().mean())))

    def plain_mlp(x, v, w, with_rgb=True):
        return fused_mlp.reference_forward(x, v, tuple(w), with_rgb)

    def bf16_heads(x_en, view_en, weights, with_rgb=True):
        w = [t.to(torch.bfloat16) for t in weights]
        s, r = fused_mlp.reference_forward(
            x_en.to(torch.bfloat16),
            None if view_en is None else view_en.to(torch.bfloat16), w, with_rgb)
        return s.float(), (None if r is None else r.float())

    fused, mlp_fwd, dtable = (field.fused_field_mlp, fused_mlp.fused_mlp_forward,
                              triplane.plane_dtable)
    Trainer.train_step, Trainer.update_extra_state = step, refresh
    out_dir = os.path.join("chiprun_out", "quality_ab")
    os.makedirs(out_dir, exist_ok=True)
    try:
        for variant in variants:
            words = variant.split()
            field.fused_field_mlp = bf16_heads if "BF16" in words else fused
            fused_mlp.fused_mlp_forward = plain_mlp if "PLAIN" in words else mlp_fwd
            triplane.plane_dtable = (triplane_kernels.plane_dtable_reference
                                     if "PLAIN" in words else dtable)
            flags = [w for w in words if w not in ("BF16", "PLAIN")]
            steps.clear()
            refreshes.clear()
            ws = os.path.join(cs.QUALITY_ROOT, "ws_ab")
            shutil.rmtree(ws, ignore_errors=True)
            t0 = time.time()
            tr = cli(cs.BEAR_PHASE1 + ["--data_type", "nerfstudio", "--data_path",
                                       path, "--workspace", ws] + flags,
                     log=lambda *_: None)
            torch.cuda.synchronize()
            print(f"variant {variant!r} | {card} | wall {time.time() - t0:.1f} s",
                  flush=True)
            per_epoch = len(steps) // max(tr.epoch, 1)
            for e, result in enumerate(tr.stats["results"]):
                seg = steps[e * per_epoch:(e + 1) * per_epoch]
                means = [statistics.mean(s[i] for s in seg) for i in range(4)]
                occ = refreshes[e] if e < len(refreshes) else (float("nan"),) * 2
                print(f"{e + 1} psnr {-result:.2f} loss_c {means[0]:.5f} loss_m "
                      f"{means[1]:.5f} fill {means[2]:.3f} overflow {means[3]:.3f} "
                      f"mean_density {occ[0]:.3f} occupied {occ[1]:.4f}", flush=True)
            tag = "_".join(words).replace("-", "") or "recipe"
            last = sorted(os.listdir(os.path.join(ws, "validation")))[-1]
            shutil.copy(os.path.join(ws, "validation", last),
                        os.path.join(out_dir, f"{tag}_{last}"))
    finally:
        Trainer.train_step, Trainer.update_extra_state = train_step, update
        field.fused_field_mlp, fused_mlp.fused_mlp_forward = fused, mlp_fwd
        triplane.plane_dtable = dtable
        shutil.rmtree(cs.QUALITY_ROOT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
