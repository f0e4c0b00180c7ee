"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  There is no silent CPU fallback: without a
    CUDA device the caller must ask for ``device="cpu"`` explicitly.  On the
    card, cuBLAS's reduced-precision bf16 reductions are turned off: the
    bf16 policy (flax's bf16 Dense and Conv) sums in f32.  And cuDNN picks
    deterministic convolution algorithms only: a captured step must replay
    as it ran eagerly, and with the SD stack's activations in contiguous
    NCHW its heuristics otherwise choose data-gradient algorithms that sum
    in a varying order (at no cost measured in the edit cells)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.deterministic = True
    return dev
