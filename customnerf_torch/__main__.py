"""``python -m customnerf_torch <main.py reconstruction flags>``

Runs reconstruction on the card with ``--data_type synthetic`` (the formats
that read files are later slices), then renders up to four validation views
and prints their PSNR.  Example, the flagship field::

    python -m customnerf_torch -O --data_type synthetic --iters 200 \\
        --grid_type triplane --triplane_res 128 512 --triplane_channels 16 8 \\
        --num_steps 40 --upsample_steps 0 --compact_frac 0.35 \\
        --compact_block 64 --bound 2 --train_conf 0.01 --soft_mask
"""

from __future__ import annotations

from customnerf_torch.config import parse_args
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine.trainer import Trainer, max_epochs_for


def main(argv=None):
    opt = parse_args(argv)
    if opt.test:
        raise NotImplementedError("--test needs checkpoints and test renders, "
                                  "which are not ported yet (ROADMAP.md "
                                  "queue A, items 'Checkpoints' and 'Eval/test "
                                  "strips')")
    trainer = Trainer(opt)
    train_loader = NeRFDataset(opt, "train", device=trainer.device).dataloader()
    valid_loader = NeRFDataset(opt, "val", device=trainer.device).dataloader()
    trainer.train(train_loader, max_epochs_for(opt, len(train_loader)))
    trainer.evaluate(valid_loader)


if __name__ == "__main__":
    main()
