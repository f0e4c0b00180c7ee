"""Class (regularisation) images for Custom Diffusion (counterpart of
``customnerf_tpu/guidance/retrieve.py``).

An existing directory with enough images is used as it is.  The JAX package
first queries LAION through ``clip_retrieval`` (``_retrieve_laion``); the
port has no network retrieval, so that step raises at once and the fallback
generates the images with the local SD sampler (``guidance/sampler.py``, 25
DDIM steps, ``{i:05d}.jpg`` through ``utils/jpeg.py``) and writes
``caption.txt`` and ``images.txt``, as the JAX fallback does.  Without a
guidance model there is nothing to generate with, and it raises the JAX
package's ``RuntimeError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from customnerf_torch.utils.jpeg import write_jpeg


def retrieve(class_prompt: str, class_images_dir: str, num_class_images: int,
             guidance=None, seed: int = 0) -> int:
    """Fill ``class_images_dir``; returns the number of images available."""
    os.makedirs(class_images_dir, exist_ok=True)
    existing = [f for f in os.listdir(class_images_dir)
                if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    if len(existing) >= num_class_images:
        return len(existing)
    try:
        return _retrieve_laion(class_prompt, class_images_dir, num_class_images)
    except Exception as e:
        print(f"[WARN] clip-retrieval unavailable ({e}); "
              f"generating class images with local SD instead.")
        if guidance is None:
            raise RuntimeError(
                "no network retrieval and no guidance model provided — "
                "cannot produce class images") from e
        return _generate_with_sd(class_prompt, class_images_dir,
                                 num_class_images, guidance, seed)


def _retrieve_laion(class_prompt, out_dir, num):
    raise RuntimeError("the port has no network retrieval (LAION through "
                       "clip-retrieval)")


def _generate_with_sd(class_prompt, out_dir, num, guidance, seed):
    from customnerf_torch.guidance.sampler import ddim_sample

    gen = torch.Generator(device=guidance.device).manual_seed(int(seed))
    names, captions = [], []
    for i in range(num):
        img = ddim_sample(guidance, class_prompt, generator=gen, num_steps=25)
        name = os.path.join(out_dir, f"{i:05d}.jpg")
        write_jpeg(name, (img.cpu().numpy() * 255).astype(np.uint8))
        names.append(name)
        captions.append(class_prompt)
    for fname, rows in (("caption.txt", captions), ("images.txt", names)):
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write("\n".join(rows))
    return num
