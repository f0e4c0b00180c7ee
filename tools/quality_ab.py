"""Variants of ``scripts/bear.sh`` phase 1 on the bear fixture, on the card,
with per-epoch diagnostics: the eval PSNR, the mean training losses, the
compaction's slab fill and overflowing-block share, and the occupancy
grid's mean density and occupied share at each refresh.

    python -m tools.quality_ab [VARIANT ...]

Each VARIANT is one quoted string of extra flags for ``bear.sh`` phase 1
(``""`` is the recipe as it stands), optionally with words that swap a
piece of the run for a study:

* ``PLAIN``: the fused-MLP and table-gradient kernels' plain PyTorch
  versions instead of the kernels;
* ``BF16``: the heads in bfloat16 (the JAX package's ``-O``/``-O2`` policy
  for its flax heads), plain PyTorch;
* ``PARITY``: ``bear.sh --parity`` phase 1's flags (``-O2``, the reference
  grid) instead of the flagship's;
* ``NOSAVE``: no ring checkpoints (the best result's ``df.pth`` is still
  written), to shorten a study;
* ``INIT=<k>``: the field initialised from seed ``k`` while ``--seed``
  keeps driving the random streams (jitter, ``sample_pdf``'s u, the image
  order);
* ``FIXTURE=<llff|dtu>``: that fixture instead of the bear.

e.g. ``python -m tools.quality_ab "" "--seed 1" "--compact_frac 0" PLAIN``.
The runs take the card's default of 8 steps a dispatch, whose steps report
their losses but not the slab fill and overflow share (``nan``); add
``--steps_per_dispatch 1`` to a variant for those.
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
    from customnerf_torch.engine import trainer as trainer_mod
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
        paths = {t: cs.wait_fixture(p, t) for t, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()

    steps, refreshes = [], []
    train_step, update = Trainer.train_step, Trainer.update_extra_state
    train_many = Trainer.train_many
    save, build_field = Trainer.save_checkpoint, trainer_mod.build_field

    def step(self, *a, **kw):
        out = train_step(self, *a, **kw)
        aux, stats = out[1], out[2]
        steps.append((float(aux["loss_c"]), float(aux.get("loss_m", 0.0)),
                      float(stats.get("slab_fill", -1)),
                      float(stats.get("overflow_frac", -1))))
        return out

    def many(self, batches):
        # a dispatch returns its steps' losses; the slab fill and overflow
        # share are read from eager steps only (--steps_per_dispatch 1)
        losses, aux = train_many(self, batches)
        m = aux.get("loss_m", torch.zeros_like(aux["loss_c"]))
        steps.extend((c, mm, float("nan"), float("nan"))
                     for c, mm in zip(aux["loss_c"].tolist(), m.tolist()))
        return losses, aux

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
    Trainer.train_many = many
    out_dir = os.path.join("chiprun_out", "quality_ab")
    os.makedirs(out_dir, exist_ok=True)
    try:
        for variant in variants:
            words = variant.split()
            field.fused_field_mlp = bf16_heads if "BF16" in words else fused
            fused_mlp.fused_mlp_forward = plain_mlp if "PLAIN" in words else mlp_fwd
            triplane.plane_dtable = (triplane_kernels.plane_dtable_reference
                                     if "PLAIN" in words else dtable)
            Trainer.save_checkpoint = (lambda self: None) if "NOSAVE" in words else save
            base = cs.BEAR_PARITY if "PARITY" in words else cs.BEAR_PHASE1
            init = [int(w[5:]) for w in words if w.startswith("INIT=")]
            trainer_mod.build_field = build_field if not init else (
                lambda opt, device=None, k=init[0]: build_field(opt.replace(seed=k), device))
            fixture = ([w[8:] for w in words if w.startswith("FIXTURE=")]
                       or ["nerfstudio"])[0]
            flags = [w for w in words if w not in ("BF16", "PLAIN", "PARITY", "NOSAVE")
                     and not w.startswith(("INIT=", "FIXTURE="))]
            steps.clear()
            refreshes.clear()
            ws = os.path.join(cs.QUALITY_ROOT, "ws_ab")
            shutil.rmtree(ws, ignore_errors=True)
            t0 = time.time()
            tr = cli(base + ["--data_type", fixture, "--data_path",
                             paths[fixture], "--workspace", ws] + flags,
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
            tag = "_".join(words).replace("-", "").replace("=", "") or "recipe"
            last = sorted(os.listdir(os.path.join(ws, "validation")))[-1]
            shutil.copy(os.path.join(ws, "validation", last),
                        os.path.join(out_dir, f"{tag}_{last}"))
    finally:
        Trainer.train_step, Trainer.update_extra_state = train_step, update
        Trainer.train_many = train_many
        Trainer.save_checkpoint, trainer_mod.build_field = save, build_field
        field.fused_field_mlp, fused_mlp.fused_mlp_forward = fused, mlp_fwd
        triplane.plane_dtable = dtable
        shutil.rmtree(cs.QUALITY_ROOT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
