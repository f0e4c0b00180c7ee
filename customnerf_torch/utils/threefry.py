"""The JAX package's initial parameters, reproduced in numpy.

The JAX package initialises its field with ``init_params(PRNGKey(seed))``:
flax folds each parameter's module path into the root key (SHA-1 of the
path, then ``fold_in``), and draws the table from ``jax.random.uniform`` and
the Dense kernels from its truncated normal (``lecun_normal``).  This module
carries the same arithmetic — threefry2x32 with JAX's partitionable layout
(``jax_threefry_partitionable``, the default), the uniform's mantissa trick
with its fused scale and shift, flax's path keys — so that a seed gives the
port's grid field the same initial parameters as the JAX package's: the
table bit for bit, the kernels to the last bits of ``erfinv`` (XLA's and
PyTorch's f32 versions round differently).

Why it matters: on ``scripts/bear.sh --parity`` the run's outcome is set by
the initial draw — some draws leave the object see-through, about 2.5 dB
lower — so a run is compared with the JAX package's only from the same
initial field (``PERF.md``).  Nothing here imports JAX.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):          # uint32 arithmetic wraps
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a seed below 2^32."""
    return (np.uint32(0), np.uint32(seed & 0xFFFFFFFF))


def fold_in(key, data: int):
    """``jax.random.fold_in``."""
    a, b = threefry2x32(key, np.uint32(0), np.uint32(data & 0xFFFFFFFF))
    return (np.uint32(a), np.uint32(b))


def param_key(root, *path):
    """The key flax hands a parameter at ``path`` — module names, then the
    scope's call count (1 for a module's first parameter)."""
    if not path:
        return root
    h = hashlib.sha1()
    for x in path:
        h.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(h.digest()[:4], "big"))


def random_bits(key, shape):
    """``jax.random.bits`` (32 bits, partitionable layout)."""
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError("more than 2^32 draws")
    out = np.empty(n, np.uint32)
    step = 1 << 18                    # chunks that stay in the host's cache
    for i in range(0, n, step):
        count = np.arange(i, min(i + step, n), dtype=np.uint32)
        a, b = threefry2x32(key, np.zeros_like(count), count)
        out[i:i + step] = a ^ b
    return out.reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses the scale and the shift into one rounding
    out = (f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out)


def lecun_normal(key, fan_in: int, shape) -> torch.Tensor:
    """flax's default Dense kernel init: a normal truncated to ±2σ with
    variance 1/fan_in (``jax.random.truncated_normal`` × stddev)."""
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32)
    a, b = torch.erf(torch.tensor([-2.0, 2.0]) / sqrt2).tolist()
    u = torch.from_numpy(uniform(key, shape, a, b))
    w = torch.clamp(sqrt2 * torch.erfinv(u),
                    float(np.nextafter(np.float32(-2), np.float32(np.inf))),
                    float(np.nextafter(np.float32(2), np.float32(-np.inf))))
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / np.float32(0.87962566103423978)
    return w * float(std)
