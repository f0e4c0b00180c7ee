"""Meshes of ranks on ``torch.distributed``: rays and scenes as data axes."""

from customnerf_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)

__all__ = ["init_distributed", "make_mesh", "pad_to_multiple", "replicate",
           "shard_batch"]
