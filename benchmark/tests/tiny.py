"""Tiny configurations of the two cells for the CPU tests: the same
recipes at widths a CPU runs in seconds."""

from __future__ import annotations

import copy
import os

import torch

from benchmark.lib import registry

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_UNET = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64, 64],
             "layers_per_block": 1, "cross_attention_dim": 32, "attention_head_dim": 4,
             "norm_num_groups": 8, "sample_size": 8}
TINY_VAE = {"in_channels": 3, "latent_channels": 4, "block_out_channels": [16, 16, 32, 32],
            "layers_per_block": 1, "norm_num_groups": 8, "sample_size": 64,
            "scaling_factor": 0.18215}


def bench():
    return registry.benchmark(ROOT)


def edit_cell():
    """(config, traffic) of the editing cell at tiny widths."""
    cfg = copy.deepcopy(registry.config(bench(), "triplane-sd15", ROOT))
    # keep_bg's L1 is a mean over pixels: scaled with their count (16² for
    # 128²), each pixel's gradient is what it is at the cell's size
    cfg.update(triplane_res=[16, 32], triplane_channels=[8, 4], occ_grid_size=32,
               max_ray_batch=128, unet=TINY_UNET, vae=TINY_VAE,
               keep_bg=cfg["keep_bg"] * 16 * 16 / (128 * 128))
    traffic = dict(registry.traffic("edit"), views=3, H=16, W=16, epoch_steps=4,
                   steps_per_dispatch=1)
    return cfg, traffic


def recon_cell():
    cfg = copy.deepcopy(registry.config(bench(), "hashgrid-sd15", ROOT))
    cfg.update(grid_levels=4, grid_base_resolution=4, log2_hashmap_size=10,
               desired_resolution=64, num_steps=8, upsample_steps=8)
    traffic = dict(registry.traffic("recon"), views=3, H=16, W=16, epoch_steps=4,
                   steps_per_dispatch=1)
    return cfg, traffic


EDIT_ONLY = ("pretrained", "text", "text_fg", "lambda_sd", "keep_bg", "cfg", "global_ratio",
             "local_t_ratio", "max_ratio", "random_bg_c", "detach_bg", "clip_view",
             "stage_time", "allow_random_guidance", "vae")


def triplane_recon_config():
    """The tri-plane field of ``triplane-sd15`` on the ``-O`` path at tiny
    widths, as a reconstruction configuration: the editing flags left out."""
    cfg, _ = edit_cell()
    cfg = {k: v for k, v in cfg.items() if k not in EDIT_ONLY}
    cfg.update(name="tiny-triplane", train_rgb=1.0, num_steps=8, compact_block=16)
    return cfg


def tiny_text_encoder():
    """A text tower as wide as the tiny UNet's context (its output is not
    used: the benchmark hands the prompts' embeddings over)."""
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.text import CLIPTextConfig, CLIPTextModel, TextEncoder
    return TextEncoder(model=build(CLIPTextModel, CLIPTextConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=4),
        generator=torch.Generator().manual_seed(0)))
