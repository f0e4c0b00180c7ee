"""Checkpoint I/O with the JAX package's ``.pth`` contract (counterpart of
``customnerf_tpu/engine/checkpoint.py``).

A ``.pth`` is one ``torch.save`` dict: ``epoch``, ``global_step``,
``stats`` and ``model``, a flat ``{dotted.flax.path: tensor}`` dict of the
flax param tree (``params.feature_net.hidden_0.kernel``, Dense kernels
``[in, out]``).  The occupancy grid's ``density_grid`` / ``density_bitfield``
go under ``model`` (the reference keeps them as model buffers) and
``mean_density`` / ``iter_density`` at the top level.  Files are
``df_ep{epoch:04d}.pth`` under ``{workspace}/checkpoints`` with a 5-deep
ring that spares ``*0.pth``.

The JAX package's Adam state (``optimizer``: numpy leaves and a pickled JAX
treedef) is neither written nor read here; the port keeps its own Adam state
under ``torch_optimizer``, which the JAX loader ignores.  JAX files hold
numpy arrays, so loading needs ``torch.load(..., weights_only=False)``.

A reference-format (torch-ngp / tcnn) file — any ``*.params`` or
``pos_en.embeddings`` key under ``model`` — goes through
``engine/torch_shim.py``, so ``--ckpt`` and ``--editing_from`` load a
reconstruction made by the original CustomNeRF.

``--ckpt_format orbax`` (the JAX package's ``OrbaxSaver``,
``checkpoint.py:183-227``) writes off the training thread: the port has no
orbax, so :class:`AsyncSaver` writes the same ``.pth`` files with
``torch.save`` on one worker thread, from a host snapshot taken on the
calling thread (:func:`snapshot`).  Reading a JAX ``.orbax`` directory is
not ported.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from customnerf_torch.engine.torch_shim import import_reference_checkpoint

OCC_ARRAY_KEYS = ("density_grid", "density_bitfield")
OCC_SCALAR_KEYS = ("mean_count", "mean_density", "iter_density")
TORCH_OPTIMIZER_KEY = "torch_optimizer"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item '{item}')")


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _to_numpy(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def checkpoint_state(params, epoch: int, global_step: int, stats: dict,
                     optimizer_state: Optional[dict] = None,
                     extra: Optional[dict] = None) -> Dict[str, Any]:
    """The dict a ``.pth`` holds.  ``params``: the flax-layout tree
    (``{"params": {…}}``) of numpy arrays; ``optimizer_state``: the port's
    ``torch.optim`` state dict; ``extra``: occupancy entries (arrays go
    under ``model``)."""
    state: Dict[str, Any] = {"epoch": epoch, "global_step": global_step,
                             "stats": stats}
    state["model"] = {k: torch.from_numpy(np.array(v, copy=True))
                      for k, v in flatten(params).items()}
    if optimizer_state is not None:
        state[TORCH_OPTIMIZER_KEY] = optimizer_state
    if extra:
        extra = dict(extra)
        for k in OCC_ARRAY_KEYS:
            if extra.get(k) is not None:
                state["model"][k] = torch.from_numpy(
                    np.array(_to_numpy(extra.pop(k)), copy=True))
        state.update(extra)
    return state


def write_checkpoint(path: str, state: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)
    return path


def snapshot(tree, buffers: Optional[dict] = None):
    """Host copies of the tensors in ``tree`` (nested dicts, lists and
    tuples; other leaves are kept as they are) → (host tree, ready).

    A CUDA tensor is copied into a pinned host buffer (reused from
    ``buffers``, keyed by its place in the tree, when its shape and dtype
    match) by a copy queued on the current stream: it reads the tensor
    after every kernel queued before it, and an in-place update queued
    after it waits for it.  ``ready`` is a CUDA event recorded after the
    copies (None when no tensor was on the card): wait on it before
    reading the host tree.  A CPU tensor is cloned."""
    state = {"cuda": False}

    def copy(t, key):
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        state["cuda"] = True
        buf = None if buffers is None else buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if buffers is not None:
                buffers[key] = buf
        return buf.copy_(t, non_blocking=True)

    def walk(node, key):
        if torch.is_tensor(node):
            return copy(node, key)
        if isinstance(node, dict):
            return {k: walk(v, key + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key + (i,)) for i, v in enumerate(node))
        return node

    host = walk(tree, ())
    ready = None
    if state["cuda"]:
        ready = torch.cuda.Event()
        ready.record()
    return host, ready


class AsyncSaver:
    """Checkpoint writes off the training thread (the JAX ``OrbaxSaver``).

    :meth:`save` takes the state's host snapshot on the calling thread, into
    pinned buffers this saver keeps and reuses, then writes the file with
    ``torch.save`` on one worker thread; one write is in flight at a time.
    :meth:`wait` joins the worker and re-raises its error: a failed write
    never passes silently."""

    def __init__(self):
        self.buffers: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def snapshot(self, tree):
        """:func:`snapshot` into this saver's buffers, after the pending
        write (which may still read them) has finished."""
        self.wait()
        return snapshot(tree, self.buffers)

    def save(self, path: str, state: Callable[[], dict], ready=None) -> str:
        """Write ``state()`` to ``path`` on the worker, which calls it once
        ``ready`` (the event of a :meth:`snapshot` it reads) has passed.
        Returns ``path``."""
        self.wait()

        def work():
            try:
                if ready is not None:
                    ready.synchronize()
                write_checkpoint(path, state())
            except BaseException as e:      # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, name="checkpoint-writer",
                                        daemon=True)
        self._thread.start()
        return path

    @property
    def pending(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_checkpoint(path: str, conf_channels: int = 1) -> Tuple[dict, dict]:
    """→ (params tree of numpy arrays, meta).  meta holds epoch,
    global_step, stats, the occupancy entries found, and the port's Adam
    state when the file has one.  ``conf_channels`` is read only by the
    reference-format import (tcnn pads the conf head's outputs)."""
    path = str(path)
    if path.endswith(".orbax"):
        raise _not_ported("reading a JAX .orbax checkpoint", ".orbax")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model" not in ckpt:
        return unflatten({k: _to_numpy(v) for k, v in ckpt.items()}), {}
    model = dict(ckpt["model"])
    meta = {"epoch": ckpt.get("epoch", 0),
            "global_step": ckpt.get("global_step", 0),
            "stats": ckpt.get("stats", {})}
    for k in OCC_ARRAY_KEYS:
        if k in model:
            meta[k] = _to_numpy(model.pop(k))
    for k in OCC_ARRAY_KEYS + OCC_SCALAR_KEYS:
        if k not in meta and k in ckpt:
            meta[k] = ckpt[k]
    if any(k.endswith(".params") for k in model) or "pos_en.embeddings" in model:
        return import_reference_checkpoint(path, conf_channels=conf_channels), meta
    if TORCH_OPTIMIZER_KEY in ckpt:
        meta[TORCH_OPTIMIZER_KEY] = ckpt[TORCH_OPTIMIZER_KEY]
    return unflatten({k: _to_numpy(v) for k, v in model.items()}), meta


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Lexicographically last .pth/.orbax (reference utils_init_nerf.py:837-845)."""
    cands = sorted(glob.glob(os.path.join(ckpt_dir, "*.pth"))
                   + glob.glob(os.path.join(ckpt_dir, "*.orbax")))
    return cands[-1] if cands else None


def prune_ring(stats: dict, ckpt_dir: str, max_keep: int = 5):
    """Ring-buffer pruning sparing *0.pth (utils_init_nerf.py:806-815)."""
    while len(stats.get("checkpoints", [])) > max_keep:
        old = os.path.join(ckpt_dir, stats["checkpoints"].pop(0))
        stem = old[:-len(".orbax")] if old.endswith(".orbax") else old[:-len(".pth")]
        if not stem.endswith("0") and os.path.isfile(old):
            os.remove(old)
