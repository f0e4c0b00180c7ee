"""The yardstick: published H100 peaks and the operations and bytes each
measured part of a step needs, counted from its shapes (or, for the UNet
and the VAE, by ``torch.utils.flop_counter`` on the meta device), never
from the program's own list of operations.

Bytes count each input byte read once and each output byte written once.
A least time is the larger of operations at the peak of the unit that runs
them and bytes at the HBM peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

HIDDEN = 64


def least_s(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / PEAK_HBM_BYTES)


def k1_macs(in_dim: int, dir_dim: int, n_out: int, with_rgb: bool) -> int:
    """Multiply-adds a sample of the fused head: three feature layers, the
    density head, and with the rgb head its two layers."""
    h = HIDDEN
    macs = in_dim * h + h * h + h * h + h * h + h * 1
    if with_rgb:
        macs += (dir_dim + h) * h + h * n_out
    return macs


def k1_call(B: int, in_dim: int, dir_dim: int, n_out: int, with_rgb: bool):
    """(flops, bytes) of one fused-head launch on B samples: positions'
    features and view features in, sigma and rgb out (f32), the weights
    read once."""
    macs = k1_macs(in_dim, dir_dim, n_out, with_rgb)
    nbytes = B * (in_dim + 1 + (dir_dim + n_out if with_rgb else 0)) * 4 + macs * 4
    return 2.0 * macs * B, nbytes


def dt_call(B: int, n_live: float, R: int, C: int):
    """(flops, bytes) of one tri-plane table-gradient launch: every
    sample's cotangent read to find the dead ones, the corners and
    fractions of the live ones, the plane written once."""
    return 8.0 * C * n_live, B * 4 * C + n_live * 16 + R * R * C * 4


def grid_encode_step(points_fwd: int, points_bwd: int, levels: int, dim: int,
                     table_rows: int):
    """(flops, bytes) of the tiled/hash grid encode of one step, counted
    for the algorithm: every point's 8 corners a level, interpolated
    (forward) and scattered (backward); coordinates in, features out, the
    cotangent in for the points that backpropagate, the table read once and
    its gradient written once."""
    per_point = levels * 8 * dim * 2.0
    flops = per_point * (points_fwd + points_bwd)
    table = table_rows * dim * 4
    nbytes = (points_fwd * (3 + levels * dim) * 4 + points_bwd * levels * dim * 4
              + table + (table if points_bwd else 0))
    return flops, nbytes


def sd_counts(unet_cfg, vae_cfg, latent_hw: int = 64, image_hw: int = 512,
              weight_bytes: int = 2) -> dict:
    """(flops, bytes) of the UNet's forward on [2, 4, h, w] (the CFG
    batch), and of the VAE encoder's forward and of its backward to the
    image, counted on the meta device with the reference's modules;
    weights at ``weight_bytes`` a parameter, inputs and outputs f32."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import sd

    meta = torch.device("meta")
    unet = sd.build(sd.UNet2DCondition, unet_cfg, device=meta).requires_grad_(False)
    vae = sd.build(sd.AutoencoderKL, vae_cfg, device=meta).requires_grad_(False)
    lat = torch.empty(2, 4, latent_hw, latent_hw, device=meta)
    ctx = unet_cfg.cross_attention_dim
    with FlopCounterMode(display=False) as fc:
        unet(lat, torch.zeros(2, dtype=torch.long, device=meta),
             torch.empty(2, 77, ctx, device=meta))
    unet_flops = fc.get_total_flops()
    img = torch.empty(1, 3, image_hw, image_hw, device=meta, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        mean, logvar = vae.moments(img)
        z = mean + logvar
    enc_flops = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        z.sum().backward()
    bwd_flops = fc.get_total_flops()
    n_unet = sum(p.numel() for p in unet.parameters())
    n_enc = (sum(p.numel() for p in vae.encoder.parameters())
             + sum(p.numel() for p in vae.quant_conv.parameters()))
    enc_bytes = weight_bytes * n_enc + 4 * (img.numel() + 2 * mean.numel())
    return {"unet": (unet_flops, weight_bytes * n_unet + 4 * (2 * 2 * lat.numel()
                                                            + 2 * 77 * ctx)),
            "vae_forward": (enc_flops, enc_bytes),
            "vae_backward": (bwd_flops, 2 * enc_bytes)}
