"""What a configuration's training step does, read from its flags in one
place, for the reference's renders and for the counts of a step's work
alike: the render path (``-O``: the occupancy march and the field on a
cross-ray compaction; ``-O2``: the dense two-pass render), the samples the
field runs on, and the occupancy refreshes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from benchmark.reference import nerf


def fast(cfg: dict) -> bool:
    """``-O``: the occupancy march (``render_rays_fast``); else ``-O2``."""
    return bool(cfg.get("O"))


def n_keep(cfg: dict) -> int:
    """Samples a ray keeps on the fast path."""
    return max(cfg["num_steps"] + cfg["upsample_steps"], 2)


def train_candidates(cfg: dict) -> int:
    """Candidates a ray marches in a training render: twice those kept."""
    return 2 * n_keep(cfg)


def eval_candidates(cfg: dict) -> int:
    """Candidates a ray marches in a full-frame render: the evaluation
    budget."""
    return max(cfg["max_steps"], 2 * n_keep(cfg))


def cascade(cfg: dict) -> int:
    return 1 + math.ceil(math.log2(cfg["bound"]))


def encoder_spec(cfg: dict):
    if cfg["grid_type"] == "triplane":
        return nerf.TriplaneSpec(tuple(cfg["triplane_res"]), tuple(cfg["triplane_channels"]))
    return nerf.GridSpec(cfg["grid_levels"], cfg["grid_level_dim"],
                         cfg["grid_base_resolution"], cfg["log2_hashmap_size"],
                         cfg["desired_resolution"], cfg["grid_type"])


@dataclass(frozen=True)
class Pass:
    """One call of the field in a training step: its samples, and whether
    it backpropagates (a density-only pass runs no rgb head)."""
    samples: int
    grad: bool


def field_passes(cfg: dict, rays: int) -> list:
    """The field's calls in one training step of ``rays`` rays: on the fast
    path one call on the compacted slab, blocks of ``compact_block`` rays
    holding ``block_budget`` samples each; on the dense path the coarse
    density-only pass and the fine pass on the merged depths."""
    if fast(cfg):
        K, G, frac = n_keep(cfg), cfg["compact_block"], cfg["compact_frac"]
        per_block = nerf.block_budget(G, K, frac) if frac > 0 else G * K
        return [Pass(-(-rays // G) * per_block, True)]
    passes = [Pass(rays * cfg["num_steps"], False)] if cfg["upsample_steps"] > 0 else []
    return passes + [Pass(rays * (cfg["num_steps"] + cfg["upsample_steps"]), True)]


def refresh_points(cfg: dict) -> int:
    """Points one occupancy refresh runs the density on (fast path only)."""
    return cascade(cfg) * cfg["occ_grid_size"] ** 3 if fast(cfg) else 0
