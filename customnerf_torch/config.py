"""Configuration for the PyTorch/CUDA CustomNeRF port.

The port's own copy of the JAX package's ``Config``: the same dataclass with
the same flags and defaults, mirroring the reference CLI flag-for-flag
(reference ``main.py:11-146``) so recipes like ``scripts/bear.sh`` parse
unchanged, including ``-O`` → ``cuda_ray``.

The precision flags act as in the JAX package:
  * ``fp16`` (set by ``-O``/``-O2``) gives the field bf16 heads
    (``FieldConfig.compute_dtype``, JAX ``trainer.py:117``);
  * ``backend``: with ``xla`` (the default) the default fused head runs the
    hand-written fused-MLP kernel's bf16 mode under ``fp16`` (the flax bf16
    policy), with ``pallas`` its f32 mode (the JAX Pallas kernel is f32);
    the variant heads follow ``fp16`` under either;
  * ``triplane_fwd_bf16`` gathers bf16 tri-plane rows; the tri-plane table
    gradient takes bf16 operands whatever the flags (``mm_bf16``, the JAX
    default);
  * the SD UNet and VAE are stored and run in bf16 on the card and in f32 on
    the CPU (``guidance/sds.py``).

``steps_per_dispatch`` K (≤ 0: 8 on the card, 1 on the CPU) runs K steps a
dispatch: on the card one captured CUDA graph of a step, replayed once a
batch (``engine/dispatch.py``).  ``ckpt_format orbax`` writes the ring's
checkpoints as ``.orbax`` directories the JAX package restores, off the
training thread (``engine/checkpoint.py``).

Deviations, all documented here:
  * ``triplane_bwd`` and ``compact_layout`` choose, in the JAX package,
    between paths that compute the same numbers; the port has one path, and
    another value warns.
  * ``profile`` traces the first epoch with ``torch.profiler`` into
    ``{workspace}/profile/``; ``validate_weights`` runs the weights drill
    and exits (``guidance/validate.py``).
  * flags the reference declares but never wires (``opt.bg_color``,
    ``opt.object_bound``, ``opt.keyword2``, see SURVEY.md §5.6) are defined
    with explicit defaults instead of being latent AttributeErrors.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # macro flags (reference main.py:12-13, 148-153)
    O: bool = False          # noqa: E741  — fp16 + cuda_ray (occupancy fast path)
    O2: bool = False         # fp16 only (dense two-pass sampling path)
    test: bool = False
    val_all_images: bool = False
    eval_interval: int = 1
    workspace: str = "workspace"
    seed: int = 0

    # training options (main.py:21-30)
    iters: int = 300000
    lr: float = 5e-4
    weight_decay: float = 0.0
    ckpt: str = "latest"
    cuda_ray: bool = False   # kept under the reference name; means "occupancy-grid fast path"
    max_steps: int = 1024
    num_steps: int = 64
    upsample_steps: int = 64
    update_extra_interval: int = 100
    max_ray_batch: int = 4096

    # model options
    density_thresh: float = 10.0

    # network backbone (main.py:36-56)
    fp16: bool = False       # on TPU: bfloat16 compute policy
    geometry_dim: int = 128
    color_dim: int = 128
    color_en: bool = False
    geometry_en: bool = False
    sigma_net_d: int = 2
    sigma_net_w: int = 256
    color_net_d: int = 3
    color_net_w: int = 256
    backbone: str = "grid"
    if_data_cuda: int = 1    # device-resident precomputed rays (always true on TPU)
    save_vedio: bool = False  # sic — reference spelling preserved for CLI parity
    if_direction: bool = False
    if_bg_model: bool = False
    if_mask: bool = False
    if_smooth: bool = False
    w: int = 400
    h: int = 300
    scale: float = 1.0
    jitter_pose: bool = False

    # dataset options (main.py:59-83)
    data_path: str = ""
    pose_path: Optional[str] = None
    data_type: str = "dtu"
    if_sphere: bool = False
    R_path: Optional[str] = None
    batch_size: int = 1
    batch_rays: int = 0
    train_resolution_level: float = 1
    eval_resolution_level: float = 4
    num_work: int = 0
    train_batch_type: str = "all_images"
    val_batch_type: str = "all_images"
    bound: float = 2.0
    scene_scale: float = 0.33
    min_near: float = 0.01
    radius_range: List[float] = field(default_factory=lambda: [0.15, 0.15])
    fovy_range: List[float] = field(default_factory=lambda: [50, 70])
    phi_range: List[float] = field(default_factory=lambda: [-180, 180])
    theta_range: List[float] = field(default_factory=lambda: [60, 90])
    angle_overhead: float = 30.0
    angle_front: float = 60.0
    lambda_eikonal: float = 1e-2

    # GUI-ish eval resolution (main.py:87-88)
    W: int = 400
    H: int = 300

    # editing switches (main.py:90-117)
    pretrained: bool = False
    ori_bg: bool = False
    soft_mask: bool = False
    random_bg_c: bool = False
    black_bg_c: bool = False
    white_bg_c: bool = False
    clip_view: bool = False
    dir_text: bool = False
    detach_bg: bool = False
    no_scalar: bool = False   # accepted + ignored (no GradScaler with bf16)
    g_only: bool = False
    l_only: bool = False
    mask_no_dir: bool = False
    mask_no_dir_nodetach: bool = False
    detach_mask_from_field: bool = False
    dont_inter_test: bool = False
    render_all: bool = False
    is360Scene: bool = False
    train_all_pixel: bool = True   # store_false flag in the reference
    video_mode: bool = False
    inter_pose: bool = False
    stage_time: bool = False

    # text / guidance (main.py:118-131)
    use_ckpt: str = "latest"
    negative: str = ""
    editing_from: Optional[str] = None
    keyword: Optional[str] = None
    refer_path: Optional[str] = None
    text: str = "text"
    text_bg: str = "text_bg"
    text_fg: str = "text_fg"
    text_fg_norm: str = "text_fg"
    text_norm: str = "text_norm"
    sd_version: str = "1.5"         # 1.5 | 2.0 | 2.1 | xl (SDXL base 1.0)
    use_cd: Optional[str] = None
    test_split: str = "test"

    # loss weights / schedule (main.py:132-141)
    train_conf: float = 0.01
    conf_thr: float = 0.5
    train_rgb: float = 1.0
    lambda_sd: float = 0.01
    keep_bg: float = 0.0
    max_ratio: float = 0.98
    cfg: float = 100.0
    train_size: int = 100
    global_ratio: float = 0.5
    local_t_ratio: float = 0.5

    dis_scale: List[float] = field(default_factory=lambda: [1, 1, 1])
    video_inter_idxs: List[int] = field(default_factory=lambda: [0, 10, 50])

    # ---- flags referenced by reference code paths but never declared there
    # (SURVEY.md §5.6) — given explicit, safe defaults here.
    bg_color: Optional[float] = None
    object_bound: Optional[float] = None
    keyword2: Optional[str] = None

    # ---- TPU-native extensions (not in the reference CLI) --------------
    backend: str = "xla"           # "xla" | "pallas" for hot ops
    mesh_shape: str = ""           # e.g. "data:8"; empty = single chip
    sd_weights: Optional[str] = None   # local dir with torch SD weights to load
    clip_weights: Optional[str] = None  # local CLIP ViT-B/32 weights
    clip_metrics: bool = False     # report CLIP score (and, with
                                   # --clip_ref_text + --pretrained, CLIP
                                   # directional score) over --test renders;
                                   # the paper's Table-1 metric family
    clip_ref_text: str = ""        # pre-edit scene caption for the
                                   # directional score ("before" text)
    grid_levels: int = 16
    grid_level_dim: int = 2
    grid_base_resolution: int = 16
    log2_hashmap_size: int = 21    # reference network_grid.py:89
    desired_resolution: int = 8192  # reference network_grid.py:90
    grid_type: str = "tiled"       # "tiled" (reference parity, network_grid.py:95)
                                   # | "hash" | "triplane" (TPU-tuned low-row field)
    triplane_res: List[int] = field(default_factory=lambda: [128, 512])
    triplane_channels: List[int] = field(default_factory=lambda: [16, 8])
                                   # one value = all levels; N values = per
                                   # level (backward flops scale R²·C, so
                                   # narrow fine levels buy throughput at
                                   # unchanged resolution: (128,512)×(16,8)
                                   # measures 25.27 dB on the bear fixture vs
                                   # 25.38 for ×16 — docs/PERF.md)
    triplane_bwd: str = "matmul"   # "matmul" (scatter-free MXU) | "scatter"
                                   # | "banded" (bucket-compacted band
                                   # matmul: ~R/33× fewer dT flops, exact
                                   # via overflow reroute — docs/PERF.md)
    triplane_fwd_bf16: bool = False  # gather bf16 packed rows.  Halves
                                   # packed-table bytes; measured NEUTRAL at
                                   # the flagship (the 19 MB f32 fine table
                                   # already sits in the fast gather regime —
                                   # cliff at ~16-33 MB, docs/PERF.md) — use
                                   # for configs whose packed tables exceed
                                   # the cliff (e.g. R≥1024 planes)
    compact_frac: float = 0.0      # >0: cross-ray active-sample compaction
                                   # on the -O fast path — the field runs on
                                   # ~frac of the [N, n_keep] slab, packed
                                   # across ray blocks (ops/compaction.py).
                                   # Exact unless a block overflows; real
                                   # captures fill ~30% → 0.5 is safe.
                                   # -1 = AUTO: once the occupancy grid is
                                   # warmed up, the trainer measures the
                                   # slab fill and sets frac = 1.3×fill
                                   # (the reference's mean_count-adaptive
                                   # march-buffer sizing, raymarching.py:
                                   # 196-233, as a static-shape analog).
    compact_block: int = 64        # rays per compaction block (64 = the
                                   # gated flagship: pooled overflow stats
                                   # beat smaller blocks at equal budget,
                                   # and the 128-slot budget quantization
                                   # gets 0.05-frac granularity)
    compact_layout: str = "planes"  # compacted-eval tensor layout:
                                   # "planes" = channel-major scalar planes
                                   # (no tiny-minor-dim materializations —
                                   # round-5 fwd-rest attack, docs/PERF.md);
                                   # "wide" = the round-3 [N, K, C] path
                                   # (kept for A/B; numerically identical)
    mlp_bias: bool = False         # tcnn FullyFusedMLPs are bias-free
    max_keep_ckpt: int = 5
    ckpt_format: str = "pth"       # "pth" (reference contract) | "orbax"
                                   # (async: .pth files written off the
                                   # training thread)
    profile: bool = False
    validate_weights: bool = False  # readiness drill: load --sd_weights /
                                 # --clip_weights through the production
                                 # paths, run one ε-prediction + VAE encode
                                 # + CLIP match, print shape/checksum
                                 # diagnostics, exit (guidance/validate.py)
    allow_random_guidance: bool = False  # opt-in: run editing with RANDOM
                                 # SD/CLIP weights (tests/plumbing only; a
                                 # semantic edit run without --sd_weights
                                 # otherwise fails loudly instead of burning
                                 # 10k iters distilling noise)
    occ_grid_size: int = 128   # occupancy grid resolution (reference: 128)
    eval_march_candidates: int = 0  # -O eval/test march candidate budget;
                                 # 0 = reference-parity max_steps (1024).
                                 # Lower values march eval frames coarser
                                 # (quality-gate before adopting; training
                                 # is unaffected)
    steps_per_dispatch: int = 0  # K train steps a dispatch (one captured
                                 # step replayed K times on the card);
                                 # <= 0 = auto (8 on the card, 1 on the CPU)

    def __post_init__(self) -> None:
        if self.O:
            self.fp16 = True
            self.cuda_ray = True
        elif self.O2:
            self.fp16 = True
        self._warn_inert_flags()
        if self.backbone != "grid":
            raise NotImplementedError(f"--backbone {self.backbone} is not implemented")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"--backend must be xla|pallas, got {self.backend}")
        if self.grid_type not in ("tiled", "hash", "triplane"):
            raise ValueError(
                f"--grid_type must be tiled|hash|triplane, got {self.grid_type}")
        if self.triplane_bwd not in ("matmul", "scatter", "banded"):
            raise ValueError(
                f"--triplane_bwd must be matmul|scatter|banded, "
                f"got {self.triplane_bwd}")
        if self.ckpt_format not in ("pth", "orbax"):
            raise ValueError(
                f"--ckpt_format must be pth|orbax, got {self.ckpt_format}")
        if not 0.0 <= self.compact_frac <= 1.0 and self.compact_frac != -1:
            raise ValueError(
                f"--compact_frac must be in [0, 1] or -1 (auto), "
                f"got {self.compact_frac}")
        if self.compact_block <= 0:
            raise ValueError(
                f"--compact_block must be positive, got {self.compact_block}")
        if self.compact_layout not in ("planes", "wide"):
            raise ValueError(
                f"--compact_layout must be planes|wide, "
                f"got {self.compact_layout}")

    # Flags accepted for CLI parity with the reference (its argparse surface,
    # main.py:11-146) but NOT wired in this rebuild — either dead in the
    # reference too (legacy NeuS/orbit-pose machinery, flags referenced by
    # unreachable code paths) or superseded by the TPU-native design
    # (device-resident data, bf16 without a GradScaler).  Setting one to a
    # non-default value warns loudly instead of silently doing nothing
    # (VERDICT r3 weak #7; SURVEY §5.6).
    _INERT_FLAGS = (
        # legacy NeuS/SIREN backbone dims (reference base.py — dead with grid)
        "geometry_dim", "color_dim", "color_en", "geometry_en",
        "sigma_net_d", "sigma_net_w", "color_net_d", "color_net_w",
        "if_direction", "if_bg_model", "if_mask", "if_smooth",
        "lambda_eikonal",
        # orbit-pose sampling knobs (reference data_utils.py rand_poses —
        # unused by the bear pipeline's real-pose datasets)
        "radius_range", "fovy_range", "phi_range", "theta_range",
        "angle_overhead", "angle_front", "jitter_pose",
        # dataloader knobs superseded by device-resident fixed-shape batches
        "batch_size", "num_work", "train_batch_type", "val_batch_type",
        "train_all_pixel",
        # misc reference flags with no effect here
        "save_vedio", "scale", "pose_path", "scene_scale", "dir_text",
        "no_scalar", "video_mode", "refer_path", "test_split",
        "video_inter_idxs", "bg_color", "object_bound",
    )

    # flags the JAX package acts on that the port does not: (flag, default,
    # why it has no effect here)
    _UNPORTED_FLAGS = (
        ("triplane_bwd", "matmul", "has no effect in the port: in the JAX "
         "package it chooses between paths that compute the same numbers"),
        ("compact_layout", "planes", "has no effect in the port: in the JAX "
         "package it chooses between paths that compute the same numbers"),
    )

    def _warn_inert_flags(self) -> None:
        for name, default, why in self._UNPORTED_FLAGS:
            if getattr(self, name) != default:
                print(f"[WARN] --{name}={getattr(self, name)!r} {why}.")
        for f in dataclasses.fields(self):
            if f.name not in self._INERT_FLAGS:
                continue
            default = (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
            if getattr(self, f.name) != default:
                print(f"[WARN] --{f.name}={getattr(self, f.name)!r} is "
                      f"accepted for reference-CLI parity but NOT wired in "
                      f"this rebuild — it has no effect (see config.py "
                      f"_INERT_FLAGS).")

    @property
    def cascade(self) -> int:
        import math
        return 1 + math.ceil(math.log2(self.bound))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _add_args(parser: argparse.ArgumentParser) -> None:
    """Register every Config field on an argparse parser, reproducing the
    reference CLI surface (booleans as store_true, lists as nargs)."""
    for f in dataclasses.fields(Config):
        name = f.name
        if name in ("O", "O2"):
            parser.add_argument(f"-{name}", action="store_true")
            continue
        flag = f"--{name}"
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        if f.type in ("bool", bool):
            if default is True:
                # reference exposes train_all_pixel as store_false
                parser.add_argument(flag, action="store_false")
            else:
                parser.add_argument(flag, action="store_true")
        elif f.type in ("List[float]", List[float]):
            parser.add_argument(flag, nargs="*", type=float, default=default)
        elif f.type in ("List[int]", List[int]):
            parser.add_argument(flag, nargs="+", type=int, default=default)
        elif f.type in ("Optional[str]", Optional[str]):
            parser.add_argument(flag, type=str, default=default)
        elif f.type in ("Optional[float]", Optional[float]):
            parser.add_argument(flag, type=float, default=default)
        elif f.type in ("int", int):
            parser.add_argument(flag, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=str, default=default)


def parse_args(argv=None) -> Config:
    parser = argparse.ArgumentParser(description="CustomNeRF (PyTorch/CUDA)")
    _add_args(parser)
    ns = parser.parse_args(argv)
    return Config(**vars(ns))


# The flagship reconstruction recipe (scripts/bear.sh:18-20): tri-plane
# (128, 512)×(16, 8), 40 kept samples a ray from 80 march candidates, and
# cross-ray compaction into 896-slot blocks of 64 rays.
FLAGSHIP_ARGS = (
    "-O --grid_type triplane --triplane_res 128 512 --triplane_channels 16 8 "
    "--num_steps 40 --upsample_steps 0 --compact_frac 0.35 --compact_block 64 "
    "--bound 2 --train_conf 0.01 --soft_mask").split()
