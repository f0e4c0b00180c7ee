"""PyTorch/CUDA port of CustomNeRF for NVIDIA Hopper (H100).

Sits beside the JAX package ``customnerf_tpu`` and keeps its module names
(``ops/``, ``models/``, ``engine/``, ``data/``) so each piece has an obvious
counterpart.  Imports ``torch`` only: nothing of JAX and nothing of the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`resolve_device`).
"""

from customnerf_torch.device import resolve_device

__all__ = ["resolve_device"]
