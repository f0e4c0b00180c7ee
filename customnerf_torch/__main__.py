"""``python -m customnerf_torch <main.py flags>``

The port's counterpart of ``main.py``, on the card: reconstruction (or,
with ``--pretrained``, LGIE/SDS editing of a saved reconstruction), an
evaluation every ``--eval_interval`` epochs (strips under
``{workspace}/validation/``, the best result as
``{workspace}/checkpoints/df.pth``), then the test path's renders under
``{workspace}/results/``.  ``--test`` only renders the test path from the
checkpoint ``--ckpt`` names.  ``--data_type`` is nerfstudio, llff, dtu or
synthetic; images are PNG or baseline JPEG.  ``--validate_weights`` runs the
weights drill (``guidance/validate.py``) and exits 0 if its report is ok, 1
otherwise, without training.  ``scripts/bear.sh``'s two phases on the
flagship field::

    python -m customnerf_torch -O --grid_type triplane --triplane_res 128 512 \\
        --triplane_channels 16 8 --num_steps 40 --upsample_steps 0 \\
        --compact_frac 0.35 --compact_block 64 \\
        --data_type nerfstudio --data_path DATA --keyword lang_bear \\
        --workspace recon --iters 3000 --train_resolution_level 7 \\
        --eval_resolution_level 4 --bound 2 --train_conf 0.01 --soft_mask \\
        --ckpt scratch

    python -m customnerf_torch <the same flags> --test \\
        --ckpt recon/checkpoints/df.pth

    python -m customnerf_torch <the same field and data flags> \\
        --workspace edit --pretrained \\
        --editing_from recon/checkpoints/df_ep0030.pth \\
        --text "a corgi in a forest" --text_fg "a corgi" --lambda_sd 0.01 \\
        --keep_bg 1000 --cfg 100 --random_bg_c --detach_bg --clip_view \\
        --stage_time --sd_version 1.5 --ckpt scratch --allow_random_guidance

``scripts/bear.sh --parity`` swaps the field flags for ``-O2``: the
reference field (tiled grid, 16 levels × 2 channels at 2^21 rows, desired
resolution 8192, the defaults) on the dense two-pass path (64 uniform + 64
importance samples, the defaults)::

    python -m customnerf_torch -O2 \
        --data_type nerfstudio --data_path DATA --keyword lang_bear \
        --workspace recon_parity --iters 3000 --train_resolution_level 7 \
        --eval_resolution_level 4 --bound 2 --train_conf 0.01 --soft_mask \
        --ckpt scratch

    python -m customnerf_torch -O2 <the same data flags> \
        --workspace edit_parity --pretrained \
        --editing_from recon_parity/checkpoints/df_ep0030.pth \
        <the phase-2 flags above>

``--editing_from`` (and ``--ckpt``) also take a reference-format checkpoint
written by the original CustomNeRF (torch-ngp / tcnn ``.pth``:
``pos_en.embeddings`` and ``*.params`` keys), on the ``-O2`` grid field.
``--compact_frac -1`` sizes the ``-O`` path's compaction from the slab fill
it measures once the occupancy grid has warmed up.  ``--steps_per_dispatch``
K (≤ 0, the default: 8 on the card, 1 on the CPU) takes K steps a dispatch,
on the card as replays of one captured CUDA graph of a step;
``--ckpt_format orbax`` writes the ring's checkpoints as the JAX package's
``.orbax`` directories (its Adam state included; the best ``df.pth`` stays a
``.pth``) off the training thread, waited for before the program exits.

``--mesh_shape data:k`` shards each step's rays over k processes
(``customnerf_torch/parallel/mesh.py``), launched by torchrun or with
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set::

    torchrun --nproc_per_node 2 -m customnerf_torch <flags> --mesh_shape data:2

The backend is NCCL when every rank has a card of its own and gloo
otherwise; the log names it and why.

Without ``--sd_weights`` (a local diffusers directory) or
``--allow_random_guidance`` the editing phase refuses to run.

Image-driven editing: tune a concept with
``python -m customnerf_torch.tune_custom_diffusion`` (its artifacts in
``--output_dir``), then edit with ``--use_cd <that dir>`` and prompts that
carry the modifier token, e.g. ``--text "a <new1> bear in a forest"
--text_fg "a <new1> bear"``.
"""

from __future__ import annotations

from customnerf_torch.config import parse_args
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine.trainer import Trainer, max_epochs_for
from customnerf_torch.parallel.mesh import init_distributed


def main(argv=None, log=print, device=None):
    """Returns the trainer it ran; ``device`` None is the card."""
    opt = parse_args(argv)
    # torchrun's environment (or MASTER_ADDR & co.) before any trainer:
    # a no-op when nothing is configured (main.py:48-49)
    init_distributed(log=log)
    if opt.validate_weights:
        from customnerf_torch.guidance.validate import validate_weights
        report = validate_weights(opt, device=device)
        raise SystemExit(0 if report["ok"] else 1)
    if opt.test:
        trainer = Trainer(opt, use_checkpoint=opt.ckpt, log=log, device=device)
        test_loader = NeRFDataset(opt, "test", R_path=opt.R_path,
                                  device=trainer.device).dataloader()
        trainer.test(test_loader, split="test")
        return trainer
    guidance = None
    if opt.pretrained and opt.lambda_sd:
        from customnerf_torch.guidance.sds import StableDiffusionGuidance
        guidance = StableDiffusionGuidance(opt, device=device)
    trainer = Trainer(opt, guidance=guidance, use_checkpoint=opt.ckpt, log=log,
                      device=device)
    train_loader = NeRFDataset(opt, "train", R_path=opt.R_path,
                               device=trainer.device).dataloader()
    valid_loader = NeRFDataset(opt, "val", R_path=opt.R_path,
                               device=trainer.device).dataloader()
    trainer.train(train_loader, max_epochs_for(opt, len(train_loader)),
                  valid_loader)
    test_loader = NeRFDataset(opt, "test", R_path=opt.R_path,
                              device=trainer.device).dataloader()
    trainer.test(test_loader, split="test")
    trainer.wait_for_saves()        # never exit with a half-written file
    return trainer


if __name__ == "__main__":
    main()
