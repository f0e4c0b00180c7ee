"""``python -m customnerf_torch.tune_custom_diffusion``: Custom Diffusion
concept tuning on the card (counterpart of
``scripts/tune_custom_diffusion.py``, flag for flag).

The reference recipe (``custom_diffusion/tuning.sh:8-24``): instance images
(JPEG or PNG) and a prompt, optional class images, 250 steps; the artifacts
(``pytorch_custom_diffusion_weights.bin`` and ``<new1>.bin``) land in
``--output_dir``, ready for ``python -m customnerf_torch … --use_cd
<output_dir>``.  The instance prompt is composed as the JAX package composes
it, ``photo of a {modifier} {instance_prompt}``, also where a recipe passes a
whole prompt.  ``--real_prior`` calls ``retrieve`` without a guidance model,
as the JAX script does: with no network it warns and tunes without class
images unless ``--class_data_dir`` already holds them.

    python -m customnerf_torch.tune_custom_diffusion \\
        --instance_data_dir data/bear/images --instance_prompt bear \\
        --class_data_dir real_reg/samples_bear --class_prompt bear \\
        --output_dir cd_bear --max_train_steps 250
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Custom Diffusion tuning (PyTorch/CUDA)")
    p.add_argument("--instance_data_dir", required=True)
    p.add_argument("--instance_prompt", required=True,
                   help="class word, e.g. 'cat' (prompt becomes 'photo of a <new1> cat')")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--class_data_dir", default=None)
    p.add_argument("--class_prompt", default="")
    p.add_argument("--num_class_images", type=int, default=200)
    p.add_argument("--real_prior", action="store_true")
    p.add_argument("--modifier_token", default="<new1>")
    p.add_argument("--initializer_token", default="ktn")
    p.add_argument("--max_train_steps", type=int, default=250)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--prior_loss_weight", type=float, default=1.0)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--sd_version", default="1.5")
    p.add_argument("--sd_weights", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--freeze_model", default="crossattn_kv",
                   choices=["crossattn_kv", "crossattn"])
    p.add_argument("--checkpointing_steps", type=int, default=250)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--validation_prompt", default=None)
    p.add_argument("--validation_steps", type=int, default=50)
    p.add_argument("--num_validation_images", type=int, default=2)
    return p


def main(argv=None, device=None, guidance=None, log=print):
    """Returns the output directory.  ``device`` None is the card;
    ``guidance`` injects a built SD stack (tests)."""
    args = build_parser().parse_args(argv)

    from customnerf_torch.config import Config
    from customnerf_torch.guidance.custom_diffusion import train_custom_diffusion

    opt = Config(data_type="synthetic", sd_version=args.sd_version,
                 sd_weights=args.sd_weights, seed=args.seed)
    if args.real_prior and args.class_data_dir:
        from customnerf_torch.guidance.retrieve import retrieve
        try:
            retrieve(args.class_prompt, args.class_data_dir, args.num_class_images)
        except Exception as e:
            print(f"[WARN] class-image retrieval failed: {e}", file=sys.stderr)

    return train_custom_diffusion(
        opt,
        instance_dir=args.instance_data_dir,
        instance_prompt=args.instance_prompt,
        output_dir=args.output_dir,
        class_dir=args.class_data_dir,
        class_prompt=args.class_prompt,
        modifier_token=args.modifier_token,
        initializer_token=args.initializer_token,
        steps=args.max_train_steps,
        lr=args.learning_rate,
        prior_loss_weight=args.prior_loss_weight,
        image_size=args.resolution,
        batch_size=args.train_batch_size,
        grad_accum=args.gradient_accumulation_steps,
        freeze_model=args.freeze_model,
        checkpointing_steps=args.checkpointing_steps,
        resume_from_checkpoint=args.resume_from_checkpoint,
        validation_prompt=args.validation_prompt,
        validation_steps=args.validation_steps,
        num_validation_images=args.num_validation_images,
        guidance=guidance, device=device, log=log,
    )


if __name__ == "__main__":
    main()
