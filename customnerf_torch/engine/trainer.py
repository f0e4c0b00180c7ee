"""Trainer: reconstruction and single-scene LGIE editing, checkpoints
(counterpart of ``customnerf_tpu/engine/trainer.py``).

Reference semantics kept:
  * Adam(betas=(0.9, 0.99), eps=1e-15) with the grid table at lr×10
    (main.py:182, network_grid.py:196-206), lr decayed per update as
    ``0.1^min(step/iters, 1)`` (main.py:189-191);
  * NaN gradients zeroed before Adam (the JAX ``optax.zero_nans``);
  * loss = train_rgb·MSE(image) + train_conf·MSE(render_mask)
    (utils_init_nerf.py:224-238);
  * ``-O`` renders through the occupancy grid (``render_rays_fast``),
    refreshed every ``update_extra_interval`` steps before the step
    (utils_init_nerf.py:602-607); without it (``-O2``) the dense two-pass
    ``render_rays`` runs and there is no occupancy state to refresh, save
    or restore (JAX ``trainer.py:188-193, 940-953, 1028``);
  * ``--steps_per_dispatch`` K (≤ 0: 8 on the card, 1 on the CPU, JAX
    ``trainer.py:583-585``): an epoch's batches go in groups of K, the
    refresh runs before a group when ``global_step % interval < len(group)``
    (``trainer.py:587-616``), and a group is one ``train_many`` (or
    ``editing_steps_many``) call — on the card one captured step replayed
    once a batch (``engine/dispatch.py``), on the CPU a plain loop; the
    losses stay on the device and are fetched once a dispatch, averaged per
    epoch as ``trainer.py:627-648`` does;
  * ``--compact_frac -1``: compaction stays off until the grid has left its
    warm-up, then the measured slab fill sets the fraction once
    (``_autotune_compaction``, JAX ``trainer.py:507-572``);
  * ``render_image`` chunked by ``max_ray_batch`` (renderer.py:1749-1765);
  * checkpoints (``engine/checkpoint.py``): saved before training and
    around each ``eval_interval`` (utils_init_nerf.py:492-506) from one
    host snapshot a state (``_host_state``, JAX ``trainer.py:921-937``),
    written under ``--ckpt_format orbax`` as the JAX package's ``.orbax``
    directories (parameters, occupancy, the Adam state as the JAX optax
    state) off the training thread (``AsyncSaver``), with a wait before
    pruning, loading and the end of ``train``, the best ``{name}.pth``
    staying a ``.pth``; the ``--ckpt``
    policy scratch|latest|latest_model|<path> and ``--editing_from``
    (utils_init_nerf.py:136-150); every load restores the
    occupancy grid, ``model_only`` ones too;
  * editing (``--pretrained``): a frozen copy of the field loaded from
    ``--editing_from``, the pt-render cache, and ``train_step`` dispatching
    to ``engine/editing.py::editing_step``; refreshes keep their cadence.

The grid field starts from the JAX package's initial parameters for
``opt.seed`` (``utils/threefry.py``), the tri-plane field from a
``torch.Generator`` seeded with it (``models/field.py``).  Randomness during training (march
and depth jitter, ``sample_pdf``'s u, refresh jitter, ``--batch_rays``
subsets, the editing bg colour, t and noises) comes from one
``torch.Generator`` on the trainer's device seeded from ``opt.seed``; its
streams differ from ``jax.random``'s.  The LGIE gate draws from
``numpy.random.RandomState(opt.seed)`` as the JAX trainer does.  The JAX
package rematerialises the compacted evaluation under editing for a TPU's
memory; the port does not.

Evaluation writes the strip ``gt | rgb | depth [| gt_mask | pred_mask | fg
| bg]`` (``utils/png.py``) and keeps the best result's checkpoint as
``{name}.pth``; ``test`` writes one PNG a pose and, where ``cv2`` is
installed, the mp4 (without it, the warning the JAX package logs when its
writer fails); ``--clip_metrics`` scores the test renders with CLIP.
``--profile`` traces the first epoch with ``torch.profiler`` (Chrome trace
under ``{workspace}/profile/``, where the JAX trainer writes its trace).
On the card the optimizer is ``torch.optim.Adam(capturable=True)`` and the
decayed lr is computed on the device from an update counter, so that a
captured step applies the lr of the update it replays.

``--mesh_shape`` (``parallel/mesh.py``, JAX ``trainer.py:146``): under a
``data`` axis of k ranks every render — a reconstruction or editing step,
and each chunk row of ``render_image`` (eval, ``--test``, the pt render) —
takes this rank's rays of the batch (whole compaction blocks of the
single-process plan), draws the batch's random numbers in the
single-process order and keeps its rows, and gathers the per-ray outputs
back into the batch's order.  The loss is then the same mean over the
global batch on every rank, each rank's backward reaches the parameters
through its own rays only, and the gradients are summed over the axis
before NaN-zeroing and Adam (JAX ``trainer.py:443-468``).  The step holds
no term on the parameters alone (the regularizers of ``ops/regularizers.py``
are not in it, and the weight decay is Adam's, after the sum), so nothing
is counted k times.  ``--batch_rays`` steps are not sharded: every rank
takes the same whole step and nothing is summed (``trainer.py:443-447``).
Under a mesh a K-step group runs as the CPU's plain loop (no CUDA graph:
collectives are not captured).  Only the first rank writes checkpoints,
strips and test frames; every rank renders.  ``--ckpt`` (a path,
``latest``, ``latest_model``) and ``--editing_from`` also read a
``.orbax`` directory, the JAX package's or the port's
(``engine/checkpoint.py::load_checkpoint_orbax``): parameters, epoch,
step, stats, the occupancy grid and, on a resume, the Adam state (moments
and update count; ``engine/pytreedef.py``).  optax's ``found_nan`` flags,
which its update never reads, are written back as they were read from a
``.orbax`` resume and as False otherwise.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time

import numpy as np
import torch

from customnerf_torch.device import resolve_device
from customnerf_torch.engine import checkpoint as ckpt_io
from customnerf_torch.engine import pytreedef, spans
from customnerf_torch.engine.convert import (adam_from_torch, adam_to_torch,
                                             flax_shapes, params_from_flax,
                                             params_to_flax)
from customnerf_torch.engine.dispatch import StepGraph
from customnerf_torch.engine.editing import editing_step, editing_steps_many
from customnerf_torch.models.field import (FieldConfig, NeRFField, param_groups,
                                           param_names)
from customnerf_torch.models.renderer import (RenderSettings, render_rays,
                                              render_rays_fast, scene_aabb)
from customnerf_torch.ops.grid import GridSpec
from customnerf_torch.ops.occupancy import (WARMUP_UPDATES, OccupancyState,
                                            init_state, march_rays_occupancy,
                                            packbits, update_grid)
from customnerf_torch.ops.ray import near_far_from_aabb
from customnerf_torch.ops.triplane import TriplaneSpec
from customnerf_torch.parallel.mesh import (RayShard, all_reduce_sum, make_mesh,
                                            replicate)
from customnerf_torch.utils import png


def build_encoder_spec(opt) -> GridSpec | TriplaneSpec:
    """The tiled / hash grid (the reference field) or the tri-plane, whose
    table gradient keeps the JAX package's bf16 operands (``mm_bf16``) and
    whose forward gathers bf16 rows under ``--triplane_fwd_bf16``
    (``trainer.py:80-95``)."""
    if opt.grid_type != "triplane":
        return GridSpec(input_dim=3, num_levels=opt.grid_levels,
                        level_dim=opt.grid_level_dim,
                        base_resolution=opt.grid_base_resolution,
                        log2_hashmap_size=opt.log2_hashmap_size,
                        desired_resolution=opt.desired_resolution,
                        gridtype=opt.grid_type)
    chans = [int(c) for c in (opt.triplane_channels
                              if isinstance(opt.triplane_channels, (list, tuple))
                              else [opt.triplane_channels])]
    if len(chans) == 1:
        chans = chans * len(opt.triplane_res)
    return TriplaneSpec(resolutions=tuple(int(r) for r in opt.triplane_res),
                        channels=tuple(chans),
                        fwd_bf16=bool(opt.triplane_fwd_bf16))


def field_config(opt) -> FieldConfig:
    """The field of ``trainer.py:106-119``: bf16 heads under ``fp16``
    (``-O``, ``-O2``, ``--fp16``), run by the fused kernel's bf16 mode with
    ``--backend xla`` and by its f32 mode with ``--backend pallas``."""
    return FieldConfig(
        bound=opt.bound,
        grid=build_encoder_spec(opt),
        train_conf=bool(opt.train_conf),
        conf_channels=2 if opt.keyword2 is not None else 1,
        detach_mask_from_field=opt.detach_mask_from_field,
        mask_no_dir=opt.mask_no_dir,
        mask_no_dir_nodetach=opt.mask_no_dir_nodetach,
        use_bias=opt.mlp_bias,
        compute_dtype="bfloat16" if opt.fp16 else "float32",
        backend=opt.backend,
    )


def build_field(opt, device=None) -> NeRFField:
    return NeRFField(field_config(opt), seed=opt.seed, device=device)


def render_settings(opt) -> RenderSettings:
    return RenderSettings(
        bound=opt.bound,
        min_near=opt.min_near,
        num_steps=opt.num_steps,
        upsample_steps=opt.upsample_steps,
        train_conf=bool(opt.train_conf),
        soft_mask=opt.soft_mask,
        conf_thr=opt.conf_thr,
        detach_bg=opt.detach_bg,
        detach_mask_from_field=opt.detach_mask_from_field,
    )


def compaction_frac(fill: float, compact_block: int, n_total: int) -> float:
    """``--compact_frac`` from a measured slab fill (JAX
    ``trainer.py:552-566``): 1.3× headroom over the mean, off above 60 %
    (a dense slab gains nothing), and the per-block budget snapped to the
    nearest 128 slots but never under 1.1× the fill."""
    frac = 0.0 if fill > 0.6 else float(min(1.0, max(0.05, fill * 1.3)))
    if frac > 0.0:
        gk = compact_block * n_total
        snapped = max(128, int(round(frac * gk / 128.0)) * 128)
        if snapped < fill * 1.1 * gk:
            snapped = max(128, -(-int(np.ceil(frac * gk)) // 128) * 128)
        frac = float(min(1.0, snapped / gk))
    return frac


def max_epochs_for(opt, loader_len: int) -> int:
    return int(math.ceil(opt.iters / max(loader_len, 1)))


def psnr(image: torch.Tensor, target: torch.Tensor) -> float:
    mse = float(torch.mean((image - target) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10))


class Trainer:
    name = "df"          # checkpoint files are {name}_ep{epoch:04d}.pth

    def __init__(self, opt, field: NeRFField | None = None, device=None,
                 log=print, guidance=None, use_checkpoint: str | None = None):
        self.device = resolve_device(device)
        self.opt = opt
        self.log = log
        self.mesh = make_mesh(opt.mesh_shape)
        self._shards = {}            # (rays, block) -> RayShard
        # the first rank writes checkpoints and images
        self.writer = (not torch.distributed.is_initialized()
                       or torch.distributed.get_rank() == 0)
        if self.mesh is not None:
            log(f"[INFO] mesh {self.mesh.shape}: this rank at {self.mesh.coords}, "
                f"backend {self.mesh.backend}")
        self.guidance = guidance
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(opt.seed))
        self.np_rng = np.random.RandomState(opt.seed)   # the LGIE gate
        self.field = field if field is not None else build_field(opt, self.device)
        self.settings = render_settings(opt)
        self.ckpt_path = os.path.join(opt.workspace, "checkpoints")

        # on the card: the lr a device tensor, written from a device update
        # counter each step, so that a captured step replays the right lr
        self._capturable = self.device.type == "cuda"
        self._lr_t = self._count_t = None
        if self._capturable:
            self._lr_t = [torch.tensor(s * opt.lr, device=self.device)
                          for s in (10.0, 1.0)]
            self._count_t = torch.zeros((), dtype=torch.float64, device=self.device)
        self.optimizer = self.make_optimizer(self.field, self._lr_t, self._capturable)
        self.n_updates = 0
        self._graphs = {}            # kind -> (key, StepGraph)
        self._state_version = 0      # bumped when a load replaces the state
        self._host_cache = None      # (key, snapshot, ready): _host_state
        # --ckpt_format orbax: the writer off the training thread (None:
        # checkpoints are written on the calling thread)
        self.saver = None
        if opt.ckpt_format == "orbax":
            self.saver = ckpt_io.AsyncSaver()
            self.log("[INFO] --ckpt_format orbax: checkpoints are .orbax "
                     "directories, written off the training thread")
        self._layout = None          # the JAX optax state's layout: optax_layout()
        self._found_nan = None       # optax's found_nan flags of a .orbax resume
        self.occ_state = None        # the -O occupancy grid; -O2 has none
        if opt.cuda_ray:
            self.occ_state = init_state(opt.cascade, grid_size=opt.occ_grid_size,
                                        device=self.device)
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [],
                      "checkpoints": [], "best_result": None}
        self.pt_dict = {}        # editing: frozen-model renders per img_path
        n_params = sum(p.numel() for p in self.field.parameters())
        self.log(f"[INFO] Trainer | {self.device} | {'bf16' if opt.fp16 else 'fp32'} "
                 f"| #parameters: {n_params}")

        # checkpoint policy (utils_init_nerf.py:136-150)
        policy = use_checkpoint if use_checkpoint is not None else opt.use_ckpt
        if opt.editing_from:
            self.log(f"[INFO] Loading {opt.editing_from} ...")
            self._load(opt.editing_from, model_only=True)
        if policy == "scratch":
            self.log("[INFO] Training from scratch ...")
        elif policy in ("latest", "latest_model"):
            path = ckpt_io.latest_checkpoint(self.ckpt_path)
            if path:
                self.log(f"[INFO] Latest checkpoint is {path}")
                self._load(path, model_only=policy == "latest_model")
            else:
                self.log("[WARN] No checkpoint found, model randomly initialized.")
        else:
            self.log(f"[INFO] Loading {policy} ...")
            self._load(policy)

        # editing: a frozen copy of the pretrained field (trainer.py:237-248)
        self.field_pretrained = self.field
        if opt.pretrained:
            source = opt.editing_from or opt.use_ckpt
            if source and os.path.exists(str(source)):
                params, _ = ckpt_io.load_checkpoint(
                    source, conf_channels=self.field.cfg.conf_channels)
                frozen = build_field(opt, self.device)
                frozen.load_state_dict(params_from_flax(params))
            else:
                frozen = copy.deepcopy(self.field)
            self.field_pretrained = frozen.requires_grad_(False)
            self.log("[INFO] loaded pretrained (frozen) model.")
        # every rank starts from the first rank's state (JAX trainer.py:44)
        occ = self.occ_state
        replicate(self.mesh, [self.field, self.field_pretrained, self.optimizer,
                              None if occ is None else [occ.density_grid, occ.bitfield,
                                                        occ.mean_density]])

    def make_optimizer(self, field, lrs=None, capturable: bool = False):
        """Adam over ``field``'s parameters, the grid table at lr×10
        (``lr_scale``); ``lrs`` the two groups' lrs (floats or device
        tensors), else the undecayed ones."""
        groups = param_groups(field)
        lrs = lrs or [10.0 * self.opt.lr, self.opt.lr]
        return torch.optim.Adam(
            [{"params": groups["grid"], "lr": lrs[0], "lr_scale": 10.0},
             {"params": groups["mlp"], "lr": lrs[1], "lr_scale": 1.0}],
            betas=(0.9, 0.99), eps=1e-15, weight_decay=self.opt.weight_decay,
            capturable=capturable)

    # ------------------------------------------------------------ schedule
    def lr_at(self, count: int) -> float:
        """Base lr of the ``count``-th update (0-based), per-step decay."""
        return self.opt.lr * 0.1 ** min(count / self.opt.iters, 1.0)

    def steps_per_dispatch(self) -> int:
        """``--steps_per_dispatch``, ≤ 0 resolved as the JAX package does:
        8 on an accelerator, 1 on the CPU (``trainer.py:583-585``)."""
        k = int(self.opt.steps_per_dispatch)
        if k <= 0:
            k = 1 if self.device.type == "cpu" else 8
        return k

    # --------------------------------------------------- occupancy refresh
    def update_extra_state(self):
        """Refresh the occupancy grid (reference renderer.py:1659-1717),
        in place: a captured step marches the tensors it was captured on.
        A host and a device span ``refresh``; counted."""
        occ = self.occ_state
        with spans.span("refresh", counter="refresh"), spans.device("refresh"):
            new = update_grid(occ, self.field.density, self.opt.bound,
                              self.opt.density_thresh, generator=self.generator)
            occ.density_grid.copy_(new.density_grid)
            occ.bitfield.copy_(new.bitfield)
            occ.mean_density.copy_(new.mean_density)
        occ.iter_density = new.iter_density

    # -------------------------------------------------------------- render
    def render(self, rays_o, rays_d, train: bool, perturb: bool,
               bg_color=None, field=None, mark=None, occ=None):
        """``-O2``: the dense two-pass ``render_rays``.  ``-O``: the fast
        path; training marches 2× the kept samples, eval marches at the
        reference's inference budget (max_steps candidates) or
        ``--eval_march_candidates``.  ``field`` defaults to the trained
        one, ``occ`` to the trainer's occupancy grid; ``mark`` is ignored
        (the stages are ``engine/spans.py``'s device spans; the argument
        stays for callers that pass it by position).  Under a ``data`` axis
        this rank renders its rays of the batch and the per-ray outputs come back
        gathered (:meth:`ray_shard`); a training render only when
        :attr:`shards_steps`."""
        opt = self.opt
        field = field if field is not None else self.field
        shard = (self.ray_shard(rays_o.shape[0])
                 if self.shards_steps or not train else None)
        if shard is not None:
            rays_o, rays_d = shard.take(rays_o), shard.take(rays_d)
        if not opt.cuda_ray:
            out = render_rays(field, rays_o, rays_d, self.settings, train=train,
                              perturb=perturb, generator=self.generator,
                              bg_color=bg_color, shard=shard)
        else:
            n_total = max(opt.num_steps + opt.upsample_steps, 2)
            n_eval = int(opt.eval_march_candidates) or max(opt.max_steps, n_total * 2)
            n_coarse = n_total * 2 if train else max(n_eval, n_total * 2)
            out = render_rays_fast(
                field, rays_o, rays_d, occ if occ is not None else self.occ_state,
                self.settings, n_coarse=n_coarse, n_keep=n_total, perturb=perturb,
                generator=self.generator, bg_color=bg_color,
                compact_frac=max(opt.compact_frac, 0.0),
                compact_block=opt.compact_block, shard=shard)
        return out if shard is None else shard.gather_outputs(out)

    @property
    def shards_steps(self) -> bool:
        """A training step's rays are sharded over the ``data`` axis, and its
        gradients summed over it: not without such an axis, nor for a
        ``--batch_rays`` reconstruction step, which every rank takes whole
        (JAX ``trainer.py:443-447``, ``:466``)."""
        return (self.mesh is not None and self.mesh.size("data") > 1
                and not (self.opt.batch_rays and not self.opt.pretrained))

    def ray_shard(self, n: int) -> RayShard | None:
        """This rank's part of a batch of ``n`` rays on the mesh's ``data``
        axis (whole blocks of the compaction plan when ``-O`` compacts);
        None without such an axis."""
        if self.mesh is None or self.mesh.size("data") == 1:
            return None
        opt = self.opt
        block = opt.compact_block if opt.cuda_ray and opt.compact_frac > 0 else None
        key = (n, block)
        if key not in self._shards:
            self._shards[key] = RayShard(self.mesh, n, block=block, device=self.device)
        return self._shards[key]

    # ---------------------------------------------------------- train step
    def loss(self, out, rgbs, mask):
        opt = self.opt
        loss_c = opt.train_rgb * torch.mean((out["image"] - rgbs) ** 2)
        aux = {"loss_c": loss_c}
        loss = loss_c
        if opt.train_conf:
            loss_m = opt.train_conf * torch.mean(
                (out["render_mask"][..., 0] - mask) ** 2)
            loss = loss + loss_m
            aux["loss_m"] = loss_m
        return loss, aux

    def apply_gradients(self, loss, mark=None, optimizer=None, count: int = 0):
        """Backward, the sum over the ``data`` axis (:meth:`reduce_gradients`),
        NaN-zeroing, the decayed lr, one Adam update: the device spans
        ``backward`` (spans opened inside it by gradient hooks close with
        it) and ``adam``.  ``optimizer``: another
        field's Adam (:meth:`make_optimizer`, a scene of multi-scene
        editing), at the lr of its own update ``count``; the trainer's
        update count then stays.  ``mark`` is ignored (as in :meth:`render`)."""
        own = optimizer is None
        optimizer = self.optimizer if own else optimizer
        with spans.device("backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.reduce_gradients(optimizer)
        with spans.device("adam"):
            if own and self._capturable:
                # lr_at on the device, from the update counter
                base = self.opt.lr * torch.pow(
                    0.1, torch.clamp(self._count_t / self.opt.iters, max=1.0))
                for group, lr in zip(self.optimizer.param_groups, self._lr_t):
                    lr.copy_(group["lr_scale"] * base)
            else:
                base = self.lr_at(self.n_updates if own else count)
                for group in optimizer.param_groups:
                    group["lr"] = group["lr_scale"] * base
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.masked_fill_(torch.isnan(p.grad), 0.0)
            optimizer.step()
            if own and self._capturable:
                self._count_t += 1
        if own:
            self.n_updates += 1

    def reduce_gradients(self, optimizer):
        """Sum ``optimizer``'s gradients over the mesh's ``data`` axis (one
        collective) when the step was sharded (:attr:`shards_steps`)."""
        if not self.shards_steps:
            return
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        all_reduce_sum(grads, self.mesh, "data")

    def train_step(self, batch, perturb: bool = True):
        """One eager reconstruction step (render, loss, backward,
        NaN-zeroing, Adam), or under ``--pretrained`` one editing step.
        Returns (loss, aux, render stats) as device tensors."""
        if self.opt.pretrained:
            return editing_step(self, batch, perturb=perturb)
        return self._recon_step(self._recon_inputs(batch), perturb=perturb)

    @staticmethod
    def _recon_inputs(batch) -> dict:
        return {"rays_o": batch.rays_o, "rays_d": batch.rays_d,
                "rgbs": batch.rgbs.reshape(-1, 3), "mask": batch.mask.reshape(-1)}

    def _recon_step(self, inputs, perturb: bool = True):
        """The step :meth:`train_step` takes and a dispatch captures:
        (loss, aux, render stats), the stats' tensors detached.  Device
        spans: ``recon.step`` › ``render`` (the renderer's stages inside),
        ``loss``, ``backward`` (› ``k1.bwd``, ``grid_encode.bwd``), ``adam``."""
        with spans.device("recon.step"):
            rays_o, rays_d = inputs["rays_o"], inputs["rays_d"]
            rgbs, mask = inputs["rgbs"], inputs["mask"]
            if self.opt.batch_rays:
                n = rays_o.shape[0]
                sel = torch.randperm(n, generator=self.generator,
                                     device=self.device)[:int(self.opt.batch_rays)]
                rgbs, mask, rays_o, rays_d = rgbs[sel], mask[sel], rays_o[sel], rays_d[sel]
            with spans.device("render"):
                out = self.render(rays_o, rays_d, train=True, perturb=perturb)
            with spans.device("loss"):
                loss, aux = self.loss(out, rgbs, mask)
            self.apply_gradients(loss)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, out["stats"]

    def train_many(self, batches):
        """``len(batches)`` reconstruction steps in one dispatch (JAX
        ``trainer.py:434-455``): on the card, replays of one captured step;
        on the CPU, the eager steps.  Returns (losses [K], aux {name: [K]})
        on the device; ``global_step`` is the caller's."""
        def step(inputs):
            loss, aux, _ = self._recon_step(inputs)
            return dict(aux, loss=loss)

        outs = self._dispatch("recon", step, [self._recon_inputs(b) for b in batches])
        return (torch.stack([o.pop("loss") for o in outs]),
                {k: torch.stack([o[k] for o in outs]) for k in outs[0]})

    def _dispatch(self, kind, step, inputs_list):
        """``step`` on each of ``inputs_list``, in order: eager on the CPU
        and under a mesh (collectives are not captured), else replays of
        one captured ``step`` (captured again whenever what it was captured
        on changed).  Returns each step's outputs."""
        if self.device.type == "cpu" or self.mesh is not None:
            return [step(inputs) for inputs in inputs_list]
        graph = self._step_graph(kind, step, inputs_list[0])
        outs = []
        for inputs in inputs_list:
            out = graph.replay(inputs)
            self.n_updates += 1
            outs.append({k: v.clone() for k, v in out.items()})
        return outs

    def _graph_key(self, kind, inputs):
        """What a captured step depends on besides its inputs' values: a
        graph captured with the tracer off holds no stamp, so switching it
        captures again."""
        occ = self.occ_state
        occ_key = None if occ is None else (
            occ.density_grid.data_ptr(), occ.bitfield.data_ptr(),
            occ.mean_density.data_ptr(), occ.iter_density > WARMUP_UPDATES)
        return (kind, self._state_version, id(self.field.cfg), occ_key,
                self.opt.compact_frac, self.opt.batch_rays, spans.enabled(),
                tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))

    def _step_graph(self, kind, step, inputs) -> StepGraph:
        key = self._graph_key(kind, inputs)
        held = self._graphs.get(kind)
        if held is None or held[0] != key:
            self._graphs.pop(kind, None)     # free the old graph's pool first
            n_updates = self.n_updates
            try:
                with spans.span("capture", counter="capture"):
                    graph = StepGraph(kind, step, inputs, self.generator,
                                      [*self.field.parameters(), self._count_t],
                                      self.optimizer.state)
            finally:
                self.n_updates = n_updates
            self._graphs[kind] = held = (key, graph)
        return held[1]

    # ------------------------------------------------ compaction auto-tune
    def measure_slab_fill(self, batch) -> float:
        """Mean share of live slots in the fast path's [N, n_keep] slab for
        one batch, marched as a training step marches."""
        opt = self.opt
        n_total = max(opt.num_steps + opt.upsample_steps, 2)
        o, d = batch.rays_o, batch.rays_d
        aabb = scene_aabb(opt.bound, o.device)
        with torch.no_grad():
            nears, fars = near_far_from_aabb(o, d, aabb, opt.min_near)
            miss = nears >= fars
            _, valid, _ = march_rays_occupancy(
                self.occ_state, o, d, torch.where(miss, 0.0, nears),
                torch.where(miss, 1.0, fars), opt.bound, n_coarse=n_total * 2,
                n_keep=n_total, perturb=True, generator=self.generator)
            return float((valid & ~miss[:, None]).float().mean())

    def _autotune_compaction(self, loader):
        """``--compact_frac -1``: once the occupancy grid has left its
        warm-up, measure the slab fill on the first batch and fix
        ``--compact_frac`` from it (``compaction_frac``); until then
        compaction stays off.  Without an occupancy grid it is off."""
        if self.occ_state is None:
            self.opt.compact_frac = 0.0
            return
        if self.occ_state.iter_density <= WARMUP_UPDATES:
            return
        batch = loader.item(0) if hasattr(loader, "item") else next(iter(loader))
        with spans.span("autotune"):
            fill = self.measure_slab_fill(batch)
        n_total = max(self.opt.num_steps + self.opt.upsample_steps, 2)
        frac = compaction_frac(fill, self.opt.compact_block, n_total)
        self.log(f"[INFO] compaction auto-tune: measured slab fill "
                 f"{fill:.3f} → --compact_frac {frac:.3f}")
        self.opt.compact_frac = frac

    # ---------------------------------------------------------- train loop
    def train_one_epoch(self, loader):
        """One epoch in dispatches of ``steps_per_dispatch`` steps, as the
        JAX ``train_one_epoch`` (``trainer.py:574-648``) groups them; the
        host span ``epoch``, the losses fetched in the span ``loss_fetch``."""
        with spans.span("epoch"):
            return self._train_one_epoch(loader)

    def _train_one_epoch(self, loader):
        if self.opt.cuda_ray and self.opt.compact_frac == -1:
            self._autotune_compaction(loader)
        self.log(f"==> Start Training Epoch {self.epoch}, "
                 f"lr={self.lr_at(self.n_updates):.6f} ...")
        k = self.steps_per_dispatch()
        pending = []            # (steps, aux of the dispatch on the device)
        batches = list(loader)
        for i in range(0, len(batches), k):
            group = batches[i:i + k]
            if (self.opt.cuda_ray and self.global_step
                    % self.opt.update_extra_interval < len(group)):
                self.update_extra_state()
            if k == 1:
                self.global_step += 1
                _, aux, _ = self.train_step(group[0])
            elif self.opt.pretrained:
                _, aux = editing_steps_many(self, group)
            else:
                _, aux = self.train_many(group)
                self.global_step += len(group)
            pending.append((len(group), aux))
        # one host transfer a dispatch; a step's loss is the sum of its aux
        total, n_steps = 0.0, 0
        with spans.span("loss_fetch"):
            for n, aux in pending:
                host = torch.stack([v.reshape(n) for v in aux.values()]).cpu().double()
                total += float(host.sum())
                n_steps += n
        avg = total / max(n_steps, 1)
        self.stats["loss"].append(avg)
        self.log(f"==> Finished Epoch {self.epoch}. average_loss {avg}")
        return avg

    def train(self, train_loader, max_epochs: int, valid_loader=None):
        """Epochs up to ``max_epochs``, saving a full checkpoint first and
        before and after each ``eval_interval``'s evaluation
        (utils_init_nerf.py:492-506); a pending write is waited for at the
        end (JAX ``trainer.py:501-503``), and the tracer's counters of the
        run are logged in one line."""
        t0 = time.time()
        counted = dict(spans.counters)
        self.save_checkpoint()
        prof = self._start_profile() if self.opt.profile else None
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_loader)
            if prof is not None:
                self._stop_profile(prof)
                prof = None
            if epoch % self.opt.eval_interval == 0:
                self.save_checkpoint()
                if valid_loader is not None:
                    self.evaluate_one_epoch(valid_loader)
                self.save_checkpoint()
        self.wait_for_saves()
        self.log(spans.counters_line(counted))
        self.log(f"[INFO] training takes {(time.time() - t0) / 60:.4f} minutes.")

    def _start_profile(self):
        """``--profile``: a ``torch.profiler`` trace of the first epoch (the
        JAX trainer's xplane trace, trainer.py:484-497), with the tracer on
        (``engine/spans.py``; the step is captured again for it)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._spans_were_on = spans.enabled()
        spans.enable(True, self.device)
        spans.reset()
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof):
        """The trace, the tracer's device spans added to it as the ``cn
        spans`` track, in ``{workspace}/profile/trace_ep{epoch}.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.opt.workspace, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_ep{self.epoch:04d}.json")
        prof.export_chrome_trace(path)
        n = spans.add_track(path)
        spans.enable(self._spans_were_on, self.device)
        self.log(f"[INFO] --profile: epoch {self.epoch} traced to {path} "
                 f"({n} device spans on the track '{spans.TRACK}')")
        self.opt.profile = False

    # ---------------------------------------------------------- checkpoints
    def _host_state(self):
        """(host snapshot, ready event) of the field, the optimizer and the
        occupancy grid, taken once a state (JAX ``trainer.py:921-937``
        takes it once a global step): the ring save before an evaluation,
        the best ``df.pth`` and the ring save after it share it.  A state
        is an update count, a load and an occupancy refresh, and the
        snapshot lives in the buffers of the saver that took it.  The
        copies are queued on the current stream, behind every step queued
        before and ahead of the next in-place update; ``ready`` (None on
        the CPU) marks their end."""
        occ = self.occ_state
        key = (self.n_updates, self._state_version,
               None if occ is None else occ.iter_density, id(self.saver))
        if self._host_cache is None or self._host_cache[0] != key:
            self._host_cache = None
            tree = {"field": self.field.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "occ": None if occ is None else {
                        "density_grid": occ.density_grid,
                        "density_bitfield": occ.bitfield,
                        "mean_density": occ.mean_density}}
            if self.saver is not None:
                host, ready = self.saver.snapshot(tree)
            else:
                with spans.span("ckpt.snapshot"):
                    host, ready = ckpt_io.snapshot(tree)
            self._host_cache = (key, host, ready)
        return self._host_cache[1], self._host_cache[2]

    def _occ_extra(self, host_occ=None, iter_density: int = 0):
        """The occupancy grid of a snapshot (its ``occ`` entry), which
        checkpoint-driven renders must march (a fresh grid cost 3.6 dB on
        bear eval frames, trainer.py:939-953); None without one."""
        if host_occ is None:
            return None
        return {"mean_density": float(host_occ["mean_density"]), "mean_count": 0,
                "density_grid": host_occ["density_grid"].detach().cpu().numpy(),
                "density_bitfield": host_occ["density_bitfield"].detach().cpu().numpy(),
                "iter_density": int(iter_density)}

    def _write(self, path, full: bool):
        """Write this global step's snapshot to ``path``: on the worker
        thread under ``--ckpt_format orbax``, else here (the first rank
        only).  Returns the path."""
        if not self.writer:
            return path
        host, ready = self._host_state()
        epoch, step, n_updates = self.epoch, self.global_step, self.n_updates
        stats = copy.deepcopy(self.stats)
        iter_density = getattr(self.occ_state, "iter_density", None)
        orbax = str(path).endswith(".orbax")
        layout = self.optax_layout() if orbax and full else None
        names, found_nan = param_names(self.field), self._found_nan

        def state():
            extra = self._occ_extra(host["occ"], iter_density)
            if not orbax:
                optim = ({"state_dict": host["optimizer"], "n_updates": n_updates}
                         if full else None)
                return ckpt_io.checkpoint_state(
                    params_to_flax(host["field"]), epoch, step, stats,
                    optimizer_state=optim, extra=extra)
            optim = None
            if full:
                adam = adam_from_torch(host["optimizer"], names, host["field"])
                leaves = pytreedef.adam_to_leaves(
                    layout, params_to_flax(adam["exp_avg"], copy=False),
                    params_to_flax(adam["exp_avg_sq"], copy=False), n_updates,
                    found_nan)
                optim = (pytreedef.dumps_treedef(list(layout.nodes)), leaves)
            return ckpt_io.orbax_state(params_to_flax(host["field"], copy=False),
                                       epoch, step, stats, optim, extra)

        if self.saver is not None:
            return self.saver.save(path, state, ready=ready)
        with spans.span("ckpt.write"):
            if ready is not None:
                ready.synchronize()
            return ckpt_io.write_checkpoint(path, state())

    def wait_for_saves(self):
        """Block until a pending checkpoint write has finished; re-raises
        its error."""
        if self.saver is not None:
            self.saver.wait()

    def optax_layout(self) -> pytreedef.OptaxLayout:
        """The layout of the JAX trainer's optax state for this field and
        ``--weight_decay`` (``engine/pytreedef.py``): how a ``.orbax``
        directory's optimizer leaves map onto the port's Adam."""
        if self._layout is None:
            self._layout = pytreedef.optax_layout(
                flax_shapes(self.field.state_dict()), bool(self.opt.weight_decay))
        return self._layout

    def save_checkpoint(self):
        """A full checkpoint (with the Adam state) of this epoch into the
        ring, a ``.orbax`` directory under ``--ckpt_format orbax``; returns
        its path.  A pending write finishes before the ring is pruned (JAX
        ``trainer.py:960-963``)."""
        suffix = ".orbax" if self.opt.ckpt_format == "orbax" else ".pth"
        file_name = f"{self.name}_ep{self.epoch:04d}{suffix}"
        self.stats["checkpoints"].append(file_name)
        self.wait_for_saves()
        if self.writer:
            ckpt_io.prune_ring(self.stats, self.ckpt_path, self.opt.max_keep_ckpt)
        return self._write(os.path.join(self.ckpt_path, file_name), full=True)

    def _load(self, path, model_only: bool = False):
        if not path or not os.path.exists(str(path)):
            self.log(f"[WARN] checkpoint {path} not found.")
            return
        self.wait_for_saves()          # never read a half-written file
        params, meta = ckpt_io.load_checkpoint(
            str(path), conf_channels=self.field.cfg.conf_channels,
            layout=None if model_only else self.optax_layout(), log=self.log)
        self.field.load_state_dict(params_from_flax(params))
        self._state_version += 1       # captured steps and snapshots are stale
        self.log("[INFO] loaded model.")
        # the occupancy grid is model state in the reference: restored on
        # model_only loads too (--editing_from, latest_model)
        if meta:
            self._restore_occ_state(meta)
        if model_only or not meta:
            return
        self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        if meta.get("stats"):
            self.stats = meta["stats"]
        optim = meta.get(ckpt_io.TORCH_OPTIMIZER_KEY)
        if optim is not None:
            state_dict = optim.get("state_dict")
            if state_dict is None:         # a .orbax directory's Adam state
                state_dict = adam_to_torch(optim["adam"], param_names(self.field),
                                           self.optimizer.state_dict()["param_groups"])
            self._found_nan = optim.get("found_nan")
            self.optimizer.load_state_dict(state_dict)
            self.n_updates = int(optim["n_updates"])
            self._bind_optimizer()
            self.log("[INFO] loaded optimizer.")
        self.log(f"[INFO] load at epoch {self.epoch}, global step {self.global_step}")

    def _bind_optimizer(self):
        """After ``load_state_dict``: the groups take this trainer's
        ``capturable`` (a file saved on the card says True, one saved on
        the CPU False) and, on the card, the device lr tensors, every
        ``step`` on the card in f32 and the loaded update count."""
        for i, group in enumerate(self.optimizer.param_groups):
            group["capturable"] = self._capturable
            if self._capturable:
                group["lr"] = self._lr_t[i]
        if not self._capturable:
            return
        for st in self.optimizer.state.values():
            if "step" in st:
                st["step"] = st["step"].to(self.device, torch.float32)
        self._count_t.fill_(self.n_updates)

    def _restore_occ_state(self, meta):
        """The occupancy state from checkpoint meta (trainer.py:1023-1050),
        under ``-O`` only."""
        if not self.opt.cuda_ray or meta.get("density_grid") is None:
            return
        g = self.opt.occ_grid_size
        grid = torch.tensor(np.asarray(meta["density_grid"], np.float32),
                            device=self.device)
        if tuple(grid.shape) != (self.opt.cascade, g ** 3):
            self.log(f"[WARN] checkpoint density_grid shape {tuple(grid.shape)} "
                     f"!= configured {(self.opt.cascade, g ** 3)}; keeping "
                     f"the fresh grid.")
            return
        mean_density = torch.tensor(float(meta.get("mean_density", 0.0)),
                                    dtype=torch.float32, device=self.device)
        bitfield = meta.get("density_bitfield")
        if bitfield is not None:
            bitfield = torch.tensor(np.asarray(bitfield, np.uint8), device=self.device)
        else:
            bitfield = packbits(grid, torch.clamp(mean_density,
                                                  max=self.opt.density_thresh))
        self.occ_state = OccupancyState(
            density_grid=grid, bitfield=bitfield, mean_density=mean_density,
            iter_density=int(meta.get("iter_density", 16)), grid_size=g)
        self.log("[INFO] restored occupancy grid from checkpoint.")

    # -------------------------------------------------------------- render
    @torch.no_grad()
    def render_image(self, rays_o, rays_d, perturb: bool = False,
                     bg_color=None, field=None):
        """Full-frame render of ``field`` (default: the trained one), chunked
        over ``max_ray_batch`` rays.  The tail is edge-padded to a whole
        chunk, as in the JAX version, so every chunk marches and compacts
        the same number of rays.  Under a ``data`` axis each chunk row is
        split over the ranks and gathered (JAX ``trainer.py:702-712``)."""
        chunk = int(self.opt.max_ray_batch)
        N = rays_o.shape[0]
        pad = (-N) % chunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o[-1:].expand(pad, 3)])
            rays_d = torch.cat([rays_d, rays_d[-1:].expand(pad, 3)])
        if bg_color is not None:
            bg_color = torch.as_tensor(bg_color, dtype=torch.float32,
                                       device=rays_o.device)
        parts = []
        for i in range(0, N + pad, chunk):
            out = self.render(rays_o[i:i + chunk], rays_d[i:i + chunk],
                              train=False, perturb=perturb, bg_color=bg_color,
                              field=field)
            keep = {k: out[k] for k in ("image", "depth", "weights_sum",
                                        "render_mask") if k in out}
            for side in ("fg", "bg"):
                if side in out:
                    keep[side] = {k: out[side][k]
                                  for k in ("image", "depth", "weights_sum")}
            parts.append(keep)

        def merge(key, sub=None):
            xs = [p[key] if sub is None else p[key][sub] for p in parts]
            return torch.cat(xs)[:N]

        merged = {}
        for k, v in parts[0].items():
            merged[k] = ({s: merge(k, s) for s in v} if isinstance(v, dict)
                         else merge(k))
        return merged

    @torch.no_grad()
    def evaluate_one_epoch(self, loader, name=None):
        """Render up to four views (all with ``--val_all_images``), write
        their strips and log their PSNR; the best mean PSNR so far saves
        ``{name}.pth`` with the occupancy grid (utils_init_nerf.py:745-752,
        817-833).  Returns the per-view PSNRs."""
        opt = self.opt
        self.log(f"++> Evaluate {opt.workspace} at epoch {self.epoch} ...")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        strips, psnrs = [], []
        for i, batch in enumerate(loader):
            if not opt.val_all_images and i >= 4:
                break
            H, W = batch.H, batch.W
            out = self.render_image(batch.rays_o, batch.rays_d)
            gt = batch.rgbs.reshape(H, W, 3)
            rgb = out["image"].reshape(H, W, 3)
            psnrs.append(psnr(rgb, gt))
            ims = [gt, rgb, out["depth"].reshape(H, W, 1).expand(H, W, 3)]
            if opt.train_conf and "render_mask" in out:
                gt_mask = batch.mask.reshape(H, W, 1).expand(H, W, 3)
                pm = out["render_mask"].reshape(H, W, -1)
                ims += [gt_mask, pm.mean(-1, keepdim=True).expand(H, W, 3),
                        out["fg"]["image"].reshape(H, W, 3),
                        out["bg"]["image"].reshape(H, W, 3)]
            strip = torch.cat(ims, dim=1).cpu().numpy()
            if opt.val_all_images:
                _write_png(os.path.join(opt.workspace, "validation_all",
                                        f"{i + 1}.png"), strip, self.writer)
            else:
                strips.append(strip)
        if strips:
            path = os.path.join(opt.workspace, "validation", f"{name}.png")
            _write_png(path, np.concatenate(strips, axis=0), self.writer)
            if self.writer:
                self.log(f"++> saved validation strip to {path}")
        mean_psnr = float(np.mean(psnrs)) if psnrs else 0.0
        self.log(f"++> eval PSNR: {mean_psnr:.2f} dB "
                 f"({[round(p, 2) for p in psnrs]})")
        self.stats["valid_loss"].append(-mean_psnr)
        self.stats["results"].append(-mean_psnr)

        # the best checkpoint ('min' over results, i.e. max PSNR) is the one
        # --test points at: it carries the occupancy grid too
        best = self.stats.get("best_result")
        if best is None or self.stats["results"][-1] < best:
            self.log(f"[INFO] New best result: {best} --> "
                     f"{self.stats['results'][-1]}")
            self.stats["best_result"] = self.stats["results"][-1]
            self.wait_for_saves()
            self._write(os.path.join(self.ckpt_path, f"{self.name}.pth"),
                        full=False)
        return psnrs

    # ---------------------------------------------------------------- test
    @torch.no_grad()
    def test(self, loader, save_path=None, name=None, write_video=True,
             split=None):
        """One PNG a pose under ``{save_path}/{name}/`` — beside the frozen
        pretrained render under ``--pretrained``, with the mask / fg / bg
        columns under ``--render_all`` — then the mp4 and, with
        ``--clip_metrics``, the CLIP scores (utils_init_nerf.py:520-569).
        Returns the frames' paths."""
        opt = self.opt
        save_path = save_path or os.path.join(opt.workspace, "results")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        if split:
            name = f"{name}_{split}"
        if self.writer:
            os.makedirs(os.path.join(save_path, name), exist_ok=True)
        self.log(f"==> Start Test, save results to {save_path}")
        side_by_side = opt.pretrained and self.field_pretrained is not self.field
        frames, paths, clip_after, clip_before = [], [], [], []
        for i, batch in enumerate(loader):
            H, W = batch.H, batch.W
            out = self.render_image(batch.rays_o, batch.rays_d)
            pred = out["image"].reshape(H, W, 3)
            if opt.clip_metrics:
                clip_after.append(pred.cpu().numpy())
            if side_by_side:
                pt = self.render_image(batch.rays_o, batch.rays_d,
                                       field=self.field_pretrained)
                pt = pt["image"].reshape(H, W, 3)
                if opt.clip_metrics:
                    clip_before.append(pt.cpu().numpy())
                pred = torch.cat([pred, pt], dim=1)
            if opt.train_conf and opt.render_all and "render_mask" in out:
                pm = out["render_mask"].reshape(H, W, -1)
                pred = torch.cat([pred, pm.mean(-1, keepdim=True).expand(H, W, 3),
                                  out["fg"]["image"].reshape(H, W, 3),
                                  out["bg"]["image"].reshape(H, W, 3)], dim=1)
            path = os.path.join(save_path, name, f"{i:03d}.png")
            frames.append(_write_png(path, pred.cpu().numpy(), self.writer))
            paths.append(path)

        if write_video and frames and self.writer:
            video_path = os.path.join(save_path, f"{name}_rgb.mp4")
            try:
                import cv2
                h, w = frames[0].shape[:2]
                vw = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     30, (w, h))
                for frame in frames:
                    vw.write(np.ascontiguousarray(frame[..., ::-1]))
                vw.release()
            except Exception as e:
                self.log(f"[WARN] mp4 write failed ({e}); PNGs saved.")
        if opt.clip_metrics and clip_after and self.writer:
            self.report_clip_metrics(np.stack(clip_after),
                                     np.stack(clip_before) if clip_before else None,
                                     save_path, name)
        self.log("==> Finished Test.")
        return paths

    def report_clip_metrics(self, after, before, save_path, name):
        """CLIP score of the test renders ``after`` [B, H, W, 3] against
        ``--text``, and with the frozen renders ``before`` and
        ``--clip_ref_text`` the directional score; written to
        ``{save_path}/{name}_clip_metrics.json``."""
        from customnerf_torch.guidance.clip_view import (
            CLIPViewMatcher, clip_directional_score, clip_score)

        opt = self.opt
        matcher = getattr(self, "clip_matcher", None)
        if matcher is None:
            if not opt.clip_weights and not opt.allow_random_guidance:
                self.log(
                    "[WARN] --clip_metrics without --clip_weights: scores "
                    "from a RANDOM CLIP are meaningless. Provide "
                    "--clip_weights (or force with --allow_random_guidance). "
                    "Skipping.")
                return None
            matcher = CLIPViewMatcher(weights_dir=opt.clip_weights,
                                      device=self.device)
            self.clip_matcher = matcher

        metrics = {"clip_score": clip_score(matcher, after, opt.text),
                   "text": opt.text, "n_views": int(len(after))}
        if before is not None and opt.clip_ref_text:
            metrics["clip_directional"] = clip_directional_score(
                matcher, before, after, opt.clip_ref_text, opt.text)
            metrics["ref_text"] = opt.clip_ref_text
        elif before is not None:
            self.log("[WARN] --clip_metrics: no --clip_ref_text given; "
                     "skipping the directional score.")
        line = " ".join(f"{k}={v:.4f}" for k, v in metrics.items()
                        if isinstance(v, float))
        self.log(f"==> CLIP metrics [{name}]: {line}")
        path = os.path.join(save_path, f"{name}_clip_metrics.json")
        with open(path, "w") as f:
            json.dump(metrics, f, indent=1)
        self.log(f"==> wrote {path}")
        return metrics


def _write_png(path: str, image: np.ndarray, write: bool = True) -> np.ndarray:
    """[H, W, 3] float in [0, 1] → an 8-bit RGB PNG (unless not ``write``);
    returns the pixels."""
    pixels = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    if write:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        png.write(path, pixels)
    return pixels
