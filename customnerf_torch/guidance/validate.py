"""``--validate_weights``: the weights drill (counterpart of
``customnerf_tpu/guidance/validate.py``).

Loads ``--sd_weights`` / ``--clip_weights`` through the port's production
paths (``guidance/weights.py::load_sd_weights``,
``clip_view.CLIPViewMatcher``), runs one text embed, one UNet ε-prediction
on 8×8 latents at t = 500, one VAE encode of a 64×64 grey image and, with
CLIP, one view match on ``RandomState(0)``'s probe, and prints per-model
parameter counts, checksums and dtypes, then the whole report as one JSON
line.  The report keeps the JAX package's keys.  ``leaves`` counts the state
dict's parameter tensors, ``checksum`` is the float64 sum of |x| over them;
shapes are the port's (NCHW latents).  The drill runs on the guidance as
the production path builds it: UNet and VAE stored in bf16 on the card,
f32 on the CPU (``dtypes`` says which).

    python -m customnerf_torch --validate_weights --sd_weights DIR \\
        --clip_weights DIR --sd_version 1.5
"""

from __future__ import annotations

import json

import numpy as np
import torch

from customnerf_torch.guidance.sds import StableDiffusionGuidance
from customnerf_torch.guidance.text import PooledText


def _module_stats(module) -> dict:
    n_params, checksum, dtypes = 0, 0.0, {}
    leaves = list(module.parameters())
    for p in leaves:
        a = p.detach().cpu().double()
        n_params += a.numel()
        checksum += float(a.abs().sum())
        dt = str(p.dtype).replace("torch.", "")
        dtypes[dt] = dtypes.get(dt, 0) + 1
    return {"leaves": len(leaves), "params": int(n_params),
            "checksum": float(checksum), "dtypes": dtypes}


@torch.no_grad()
def validate_weights(opt, guidance=None, clip_matcher=None, device=None) -> dict:
    """Run the drill; returns (and prints) the report.  ``guidance`` and
    ``clip_matcher`` are injectable (tests); otherwise the full-width stack
    is built on ``device`` (the card unless the caller asks for the CPU)."""
    report: dict = {"mode": "validate_weights", "sd_weights": opt.sd_weights,
                    "clip_weights": opt.clip_weights, "sd_version": opt.sd_version}
    if guidance is None:
        opt.allow_random_guidance = True        # the drill runs weight-less too
        guidance = StableDiffusionGuidance(opt, device=device)
    elif opt.sd_weights:
        from customnerf_torch.guidance.weights import load_sd_weights
        load_sd_weights(guidance, opt.sd_weights)
    dev = guidance.device

    for name, module in (("unet", guidance.unet), ("vae", guidance.vae),
                         ("text_encoder", guidance.text_encoder.model)):
        report[name] = r = _module_stats(module)
        print(f"[validate] {name}: {r['params']:,} params in {r['leaves']} leaves, "
              f"checksum {r['checksum']:.6e}, dtypes {r['dtypes']}")

    prompt = opt.text or "a photo of a corgi"
    text_z, pooled = guidance.get_text_embeds([prompt], [""]), None
    if isinstance(text_z, PooledText):          # xl: the context and the pooled
        text_z, pooled = text_z
    report["text_embed"] = {"shape": list(text_z.shape),
                            "checksum": float(text_z.double().abs().sum())}
    print(f"[validate] text embed '{prompt}': shape {report['text_embed']['shape']}, "
          f"checksum {report['text_embed']['checksum']:.6e}")

    # 8×8 latents: divisible by the UNet's 3 downsamples, cheap everywhere
    lat = torch.zeros(2, 4, 8, 8, device=dev)
    eps = guidance.unet(lat, torch.full((2,), 500, device=dev), text_z,
                        cd_kv=getattr(guidance, "cd_kv", None),
                        added_cond=guidance.added_cond(pooled)).double().cpu().numpy()
    report["eps_prediction"] = {"shape": list(eps.shape),
                                "finite": bool(np.isfinite(eps).all()),
                                "checksum": float(np.abs(eps).sum()),
                                "std": float(eps.std())}
    print(f"[validate] UNet ε-prediction: shape {list(eps.shape)}, "
          f"finite={report['eps_prediction']['finite']}, "
          f"std {report['eps_prediction']['std']:.4f}")

    img = torch.full((1, 3, 64, 64), 0.5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    latents = guidance.encode_imgs(img, generator=gen).double().cpu().numpy()
    report["vae_encode"] = {"shape": list(latents.shape),
                            "finite": bool(np.isfinite(latents).all()),
                            "std": float(latents.std())}
    print(f"[validate] VAE encode: shape {list(latents.shape)}, "
          f"finite={report['vae_encode']['finite']}, std {report['vae_encode']['std']:.4f}")

    if clip_matcher is None and (opt.clip_weights or opt.clip_view):
        from customnerf_torch.guidance.clip_view import CLIPViewMatcher
        clip_matcher = CLIPViewMatcher(weights_dir=opt.clip_weights, seed=opt.seed,
                                       device=dev)
    if clip_matcher is not None:
        report["clip"] = _module_stats(clip_matcher.model)
        probe = np.random.RandomState(0).rand(1, 224, 224, 3).astype(np.float32)
        cdev = next(clip_matcher.model.parameters()).device
        probs = np.asarray(clip_matcher.match_probs(torch.from_numpy(probe).to(cdev)),
                           np.float64)
        report["clip_match"] = {"probs": [float(p) for p in probs.reshape(-1)],
                                "finite": bool(np.isfinite(probs).all())}
        print(f"[validate] CLIP ({report['clip']['params']:,} params, checksum "
              f"{report['clip']['checksum']:.6e}) view match probs: "
              f"{report['clip_match']['probs']}")
    else:
        print("[validate] no --clip_weights / --clip_view: CLIP skipped")

    report["ok"] = bool(report["eps_prediction"]["finite"]
                        and report["vae_encode"]["finite"]
                        and report.get("clip_match", {}).get("finite", True))
    report["weights_loaded"] = bool(opt.sd_weights)
    print(json.dumps(report))
    return report
