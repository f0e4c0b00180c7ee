"""``python -m customnerf_torch <main.py flags>``

Runs on the card with ``--data_type synthetic`` (the formats that read files
are later slices): reconstruction, or with ``--pretrained`` LGIE/SDS
editing of a saved reconstruction, then renders up to four validation views
and prints their PSNR.  Checkpoints go to ``{workspace}/checkpoints``.  The
two phases of ``scripts/bear.sh`` on the flagship field::

    python -m customnerf_torch -O --data_type synthetic --iters 200 \\
        --grid_type triplane --triplane_res 128 512 --triplane_channels 16 8 \\
        --num_steps 40 --upsample_steps 0 --compact_frac 0.35 \\
        --compact_block 64 --bound 2 --train_conf 0.01 --soft_mask \\
        --workspace recon --ckpt scratch

    python -m customnerf_torch <the same field flags> --workspace edit \\
        --pretrained --editing_from recon/checkpoints/df_ep0002.pth \\
        --text "a corgi in a forest" --text_fg "a corgi" --lambda_sd 0.01 \\
        --keep_bg 1000 --cfg 100 --random_bg_c --detach_bg --clip_view \\
        --stage_time --sd_version 1.5 --ckpt scratch --allow_random_guidance

Without ``--sd_weights`` (a local diffusers directory) or
``--allow_random_guidance`` the editing phase refuses to run.
"""

from __future__ import annotations

from customnerf_torch.config import parse_args
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine.trainer import Trainer, max_epochs_for


def main(argv=None):
    opt = parse_args(argv)
    if opt.test:
        raise NotImplementedError("--test needs test renders, which are not "
                                  "ported yet (ROADMAP.md queue A, item "
                                  "'Eval/test strips')")
    guidance = None
    if opt.pretrained and opt.lambda_sd:
        from customnerf_torch.guidance.sds import StableDiffusionGuidance
        guidance = StableDiffusionGuidance(opt)
    trainer = Trainer(opt, guidance=guidance, use_checkpoint=opt.ckpt)
    train_loader = NeRFDataset(opt, "train", device=trainer.device).dataloader()
    valid_loader = NeRFDataset(opt, "val", device=trainer.device).dataloader()
    trainer.train(train_loader, max_epochs_for(opt, len(train_loader)),
                  valid_loader)
    trainer.evaluate(valid_loader)


if __name__ == "__main__":
    main()
