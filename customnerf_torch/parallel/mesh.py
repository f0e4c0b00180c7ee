"""Process meshes on ``torch.distributed`` (counterpart of
``customnerf_tpu/parallel/mesh.py``): rays and scenes as data-parallel axes.

A ``--mesh_shape`` spec such as ``"scene:2,data:4"`` lays the world's ranks
out on named axes, the last axis the fastest-varying, as in JAX.  A rank
joins one process group per axis: the ranks that differ from it on that
axis alone.  The trainer shards a step's rays on ``data`` and all-reduces
the gradients over that group; multi-scene editing splits its scenes on
``scene``.  Parameters are replicated (every rank holds them all and takes
the same update).

Backend, by one rule (:func:`choose_backend`): ``nccl`` when every rank of
a host has a card of its own, ``gloo`` otherwise (the CPU, and ranks that
share one card, which NCCL refuses).  Under gloo a CUDA tensor is copied to
the host before each collective and back after it, explicitly, and under
NCCL a host tensor to the card (:func:`_comm`).  Nothing here catches a
collective's failure.

Ray sharding keeps the single-process plan (:class:`RayShard`).  With
cross-ray compaction the renderer edge-pads a batch of n rays to whole
blocks of G, permutes them with ``ray_permutation`` and packs each block
of G; a rank holds whole blocks of that plan, dealt out in order, and
when the blocks do not divide the k ranks, blocks of padding follow them.
Without compaction a rank holds a contiguous range, edge-padded
(``pad_to_multiple(mode="edge")``) to a multiple of k.  Padded rays
march nothing, as the renderer's own padding, and are cut off before the
loss.  Every rank draws the random numbers of the whole batch, in the
single-process order, and keeps its rows: the generators of all ranks
stay in step, and the occupancy refresh, computed on every rank from the
same parameters and draws, gives the same grid everywhere.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from customnerf_torch.ops.compaction import ray_permutation


def choose_backend(local_world_size: int) -> tuple[str, str]:
    """(backend, the rule that chose it)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= local_world_size:
        return "nccl", (f"{cards} CUDA device(s) for {local_world_size} local "
                        f"rank(s): every rank has a card of its own")
    return "gloo", (f"{cards} CUDA device(s) for {local_world_size} local "
                    f"rank(s): not a card per rank (NCCL refuses two ranks on "
                    f"one device), collectives through the host")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, log=print) -> bool:
    """``torch.distributed.init_process_group`` when configured, by the
    arguments or by torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``).  Returns False, doing nothing, when nothing is
    configured; True once the group is up.  ``coordinator_address`` is
    ``host:port``.  Under ``nccl`` the rank takes the card ``LOCAL_RANK``."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    backend, rule = choose_backend(local_world)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    log(f"[INFO] torch.distributed: rank {rank} of {world} (local {local_rank} "
        f"of {local_world}), backend {backend}: {rule}")
    return True


@dataclass
class Mesh:
    """Named axes over the world's ranks.  ``ranks`` holds the global ranks
    in the mesh's shape; ``coords`` is this rank's index on each axis;
    ``groups`` one process group per axis (None in a one-process world)."""
    axis_names: tuple
    ranks: np.ndarray
    coords: dict
    groups: dict = field(default_factory=dict)
    backend: str = "gloo"

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(spec: str = "") -> Optional[Mesh]:
    """A mesh from an ``'axis:count,axis:count'`` spec; ``''`` → None.  The
    mesh spans the whole world: a spec that needs more ranks than the world
    has raises ``ValueError`` (as the JAX version does), and so does one
    that leaves ranks out.  Every rank must call it, with the same spec:
    ``dist.new_group`` is collective."""
    if not spec:
        return None
    axes = []
    for part in spec.split(","):
        name, count = part.split(":")
        axes.append((name.strip(), int(count)))
    shape = tuple(c for _, c in axes)
    total = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if total > world:
        raise ValueError(f"mesh spec {spec} needs {total} ranks, have {world}")
    if total < world:
        raise ValueError(f"mesh spec {spec} uses {total} of the {world} ranks; "
                         f"every rank must be on the mesh")
    ranks = np.arange(total).reshape(shape)
    names = tuple(n for n, _ in axes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    if dist.is_initialized():
        for i, name in enumerate(names):
            # one group per line along axis i; every rank creates every group
            lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(axis_names=names, ranks=ranks, coords=coords, groups=groups,
                backend=backend)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0,
                    mode: str = "constant"):
    """Pad ``axis`` up to a multiple; returns (padded, original length).
    ``mode="edge"`` repeats the last row instead of zeros, as rays need: a
    zero-direction ray gives far = inf, and 0·inf turns every parameter's
    gradient into NaN even though the padded outputs are cut off."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if mode == "edge":
        last = x.narrow(axis, n - 1, 1)
        pad = last.expand(*[rem if d == axis else s for d, s in enumerate(x.shape)])
    elif mode == "constant":
        pad = x.new_zeros([rem if d == axis else s for d, s in enumerate(x.shape)])
    else:
        raise ValueError(f"pad_to_multiple: unknown mode {mode!r}")
    return torch.cat([x, pad], dim=axis), n


def shard_batch(mesh: Optional[Mesh], batch, axis: str = "data"):
    """This rank's slice along dim 0 of every tensor of ``batch`` (a tensor,
    or a tuple, list or dict of them); the length must divide the axis
    (pad first with :func:`pad_to_multiple`)."""
    if mesh is None:
        return batch
    k, i = mesh.size(axis), mesh.index(axis)

    def one(x):
        if x.shape[0] % k:
            raise ValueError(f"shard_batch: {x.shape[0]} rows do not divide "
                             f"the {axis} axis of {k}")
        n = x.shape[0] // k
        return x[i * n:(i + 1) * n]
    return _map(one, batch)


def replicate(mesh: Optional[Mesh], state):
    """Broadcast ``state`` (a module, an optimizer, a tensor or a tuple,
    list or dict of them) in place from the first rank of each axis group,
    axis after axis; returns ``state``."""
    if mesh is None:
        return state
    tensors = _tensors(state)
    for axis in mesh.axis_names:
        group = mesh.group(axis)
        if group is None or mesh.size(axis) == 1:
            continue
        src = int(np.take(mesh.ranks, 0, axis=mesh.axis_names.index(axis))
                  [tuple(mesh.index(a) for a in mesh.axis_names if a != axis)])
        for t in tensors:
            c = _comm(t, mesh)
            dist.broadcast(c, src=src, group=group)
            if c is not t:
                t.copy_(c)
    return state


def all_reduce_sum(tensors, mesh: Optional[Mesh], axis: str = "data"):
    """Sum ``tensors`` in place over the axis group, flattened into one
    buffer (one collective)."""
    if mesh is None or mesh.size(axis) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    c = _comm(flat, mesh)
    dist.all_reduce(c, group=mesh.group(axis))
    flat = c.to(flat.device)
    pos = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[pos:pos + n].view_as(t))
        pos += n


def all_gather_cat(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Concatenate the axis group's equal-shaped ``x`` along dim 0, in the
    axis's order."""
    c = _comm(x.contiguous(), mesh)
    parts = [torch.empty_like(c) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, c, group=mesh.group(axis))
    return torch.cat(parts).to(x.device)


def _comm(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` where the backend's collectives take it: a host copy of a CUDA
    tensor under gloo (its CUDA collectives are not used), a card copy of a
    host tensor under NCCL; else ``t`` itself."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.detach().cpu()
    if mesh.backend == "nccl" and not t.is_cuda:
        return t.detach().cuda()
    return t


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _tensors(state) -> list:
    if isinstance(state, torch.Tensor):
        return [state.data]
    if isinstance(state, torch.nn.Module):
        return [t.data for t in [*state.parameters(), *state.buffers()]]
    if isinstance(state, torch.optim.Optimizer):
        return [v for s in state.state.values() for v in s.values()
                if isinstance(v, torch.Tensor)]
    if isinstance(state, dict):
        return [t for v in state.values() for t in _tensors(v)]
    if isinstance(state, (tuple, list)):
        return [t for v in state for t in _tensors(v)]
    return []


# ---------------------------------------------------------------- rays
class RayShard:
    """This rank's part of a batch of ``n`` rays on the ``data`` axis.

    ``rows`` [m] are the positions, in the padded batch of ``n_padded``
    rays, of the rays this rank holds, in the order it holds them.  With
    compaction (``block`` G) they are whole blocks of the single-process
    plan: ``ray_permutation`` of the ``n_plan`` = n rounded up to whole
    blocks, as the renderer plans one process's batch, then blocks of
    padding up to a multiple of G·k; else a contiguous range (``n_plan`` =
    n).  Padded rays march nothing (``pad_mask``), as the renderer's own.
    :meth:`take` cuts a batch-wide tensor to the rows, edge-padded;
    :meth:`draw_rows` indexes the single-process draws (a padded ray takes
    the last ray's, as the renderer's edge padding does); :meth:`gather`
    puts the ranks' outputs back into the batch's order, with a backward
    that hands each rank its rows of the cotangent (every rank computes the
    same loss on the gathered outputs)."""

    def __init__(self, mesh: Mesh, n: int, block: Optional[int] = None,
                 device=None):
        k, i = mesh.size("data"), mesh.index("data")
        self.mesh, self.n, self.block = mesh, n, block
        if block:
            n_plan = -(-n // block) * block
            perm, _ = ray_permutation(n_plan)
        else:
            n_plan, perm = n, np.arange(n)
        unit = (block or 1) * k
        self.n_padded = -(-n_plan // unit) * unit
        order = np.concatenate([perm, np.arange(n_plan, self.n_padded)])
        per = self.n_padded // k
        self.rows = torch.from_numpy(order[i * per:(i + 1) * per].copy()).to(device)
        self.inverse = torch.from_numpy(np.argsort(order)).to(device)
        self.draw_rows = torch.clamp(self.rows, max=n - 1)
        self.pad_mask = self.rows >= n

    def take(self, x: torch.Tensor) -> torch.Tensor:
        padded, _ = pad_to_multiple(x, self.n_padded, mode="edge")
        return padded[self.rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherRows.apply(x, self)

    def gather_outputs(self, out: dict) -> dict:
        """The per-ray outputs a caller reads (``image``, ``depth``,
        ``weights_sum``, ``render_mask``, ``black_image``, and the same of
        ``fg`` / ``bg``) in the batch's order; ``stats`` stay this rank's.
        Per-sample outputs are not gathered."""
        keys = ("image", "depth", "weights_sum", "render_mask", "black_image")
        full = {k: self.gather(out[k]) for k in keys if k in out}
        for side in ("fg", "bg"):
            if side in out:
                full[side] = {k: self.gather(out[side][k])
                              for k in ("image", "depth", "weights_sum")}
        full["stats"] = out.get("stats", {})
        return full


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        every = all_gather_cat(x, shard.mesh, "data")     # [n_padded, ...]
        return every[shard.inverse][:shard.n]

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        padded, _ = pad_to_multiple(grad, shard.n_padded)
        return padded[shard.rows], None
