"""NeRF sin/cos frequency embedding (counterpart of
``customnerf_tpu/ops/frequency.py``).

Layout ``[x, sin(2⁰x), cos(2⁰x), …, sin(2^(m−1)x), cos(2^(m−1)x)]`` →
3·(1 + 2m) dims, 27 at multires 4 (reference ``nerf/base.py:10-77``).
"""

import torch


def freq_encode_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def freq_encode(x: torch.Tensor, multires: int = 4) -> torch.Tensor:
    """x: [..., D] → [..., D·(1 + 2·multires)]."""
    out = [x]
    for i in range(multires):
        freq = 2.0 ** i
        out.append(torch.sin(x * freq))
        out.append(torch.cos(x * freq))
    return torch.cat(out, dim=-1)
