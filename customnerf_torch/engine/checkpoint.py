"""Checkpoint I/O with the JAX package's ``.pth`` and ``.orbax`` contracts
(counterpart of ``customnerf_tpu/engine/checkpoint.py``).

A ``.pth`` is one ``torch.save`` dict: ``epoch``, ``global_step``,
``stats`` and ``model``, a flat ``{dotted.flax.path: tensor}`` dict of the
flax param tree (``params.feature_net.hidden_0.kernel``, Dense kernels
``[in, out]``).  The occupancy grid's ``density_grid`` / ``density_bitfield``
go under ``model`` (the reference keeps them as model buffers) and
``mean_density`` / ``iter_density`` at the top level.  Files are
``df_ep{epoch:04d}.pth`` under ``{workspace}/checkpoints`` with a 5-deep
ring that spares ``*0.pth``.  The port keeps its Adam state under
``torch_optimizer``, which the JAX loader ignores (the JAX package's own
``optimizer`` entry of a ``.pth`` is neither written nor read here).  JAX
files hold numpy arrays, so loading needs ``torch.load(...,
weights_only=False)``.

A reference-format (torch-ngp / tcnn) file — any ``*.params`` or
``pos_en.embeddings`` key under ``model`` — goes through
``engine/torch_shim.py``, so ``--ckpt`` and ``--editing_from`` load a
reconstruction made by the original CustomNeRF.

A ``.orbax`` directory is what the JAX ``OrbaxSaver`` (:183-227) writes
through orbax's ``PyTreeCheckpointHandler``: ``_METADATA`` naming the
tree's leaves and an OCDBT store of zarr v2 arrays holding ``meta``
(epoch, global step, the pickled stats, the occupancy entries), ``model``
(the flax tree) and ``optimizer`` (the optax state's leaves, numbered in
flatten order, and its pickled treedef).  It is read and written without
orbax, tensorstore or zstandard (``engine/ocdbt.py``, ``utils/zstd.py``,
``engine/pytreedef.py``).  :func:`load_checkpoint_orbax` returns what the
JAX loader (:229-256) returns, the Adam state as the port's; under
``--ckpt_format orbax`` :func:`write_orbax_tree` writes the directories the
JAX loader and orbax read (:func:`orbax_state`), committed by a rename as
orbax commits them.

Checkpoints under ``--ckpt_format orbax`` are written off the training
thread (:class:`AsyncSaver`), from a host snapshot taken on the calling
thread (:func:`snapshot`); the best ``{name}.pth`` stays a ``.pth`` there.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import math
import os
import pickle
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from customnerf_torch.engine import pytreedef, spans
from customnerf_torch.engine.convert import params_from_flax
from customnerf_torch.engine.ocdbt import OcdbtStore, write_store
from customnerf_torch.engine.torch_shim import import_reference_checkpoint
from customnerf_torch.utils import zstd

OCC_ARRAY_KEYS = ("density_grid", "density_bitfield")
OCC_SCALAR_KEYS = ("mean_count", "mean_density", "iter_density")
TORCH_OPTIMIZER_KEY = "torch_optimizer"


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
    """``state`` to ``path``: a ``.orbax`` directory (:func:`orbax_state`'s
    tree) or a ``.pth`` file (:func:`checkpoint_state`'s dict)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if str(path).endswith(".orbax"):
        write_orbax_tree(path, state)
    else:
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

    :meth:`snapshot` takes the state's host snapshot on the calling thread,
    into pinned buffers this saver keeps and reuses; :meth:`save` then
    writes it (:func:`write_checkpoint`: a ``.orbax`` directory or a
    ``.pth``) on one worker thread; one write is in flight at a time.
    :meth:`wait` joins the worker and re-raises its error: a failed write
    never passes silently.  The time each call holds the calling thread is
    the tracer's counter ``saver_block`` (host spans ``ckpt.snapshot``,
    ``ckpt.save``, ``ckpt.wait``), the worker's writes ``saver_write``
    (``engine/spans.py``)."""

    def __init__(self):
        self.buffers: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def snapshot(self, tree):
        """:func:`snapshot` into this saver's buffers, after the pending
        write (which may still read them) has finished."""
        self.wait()
        with spans.span("ckpt.snapshot", counter="saver_block"):
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
                t0 = time.perf_counter()
                write_checkpoint(path, state())
                spans.count("saver_write", time.perf_counter() - t0)
            except BaseException as e:      # surfaced by wait()
                self._error = e

        with spans.span("ckpt.save", counter="saver_block"):
            self._thread = threading.Thread(target=work, name="checkpoint-writer",
                                            daemon=True)
            self._thread.start()
        return path

    @property
    def pending(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            with spans.span("ckpt.wait", counter="saver_block"):
                self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_checkpoint(path: str, conf_channels: int = 1,
                    layout: Optional[pytreedef.OptaxLayout] = None,
                    log=print) -> Tuple[dict, dict]:
    """→ (params tree of numpy arrays, meta).  meta holds epoch,
    global_step, stats, the occupancy entries found, and the port's Adam
    state when the file has one (for a ``.orbax`` directory, when
    ``layout`` is given: :func:`load_checkpoint_orbax`).  ``conf_channels``
    is read only by the reference-format import (tcnn pads the conf head's
    outputs)."""
    path = str(path)
    if path.endswith(".orbax"):
        return load_checkpoint_orbax(path, layout, log)
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
    """Ring-buffer pruning sparing *0.pth and *0.orbax
    (utils_init_nerf.py:806-815): a pruned ``.orbax`` entry is a directory,
    removed with its tree, as the JAX package's ``prune_ring`` does."""
    while len(stats.get("checkpoints", [])) > max_keep:
        old = os.path.join(ckpt_dir, stats["checkpoints"].pop(0))
        stem = old[:-len(".orbax")] if old.endswith(".orbax") else old[:-len(".pth")]
        if stem.endswith("0"):
            continue
        if os.path.isdir(old):
            shutil.rmtree(old)
        elif os.path.exists(old):
            os.remove(old)


# ------------------------------------------------------------------ .orbax
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_POOL_BYTES = 8 << 20         # stored bytes above which leaves are read in threads


def _fill(dtype, fill_value):
    if fill_value is None:
        return dtype.type(0)
    if isinstance(fill_value, str):
        fill_value = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[fill_value]
    return dtype.type(fill_value)


def read_zarr_array(store: OcdbtStore, name: str, what: str = "") -> np.ndarray:
    """The zarr v2 array ``name`` of an OCDBT store: ``.zarray``'s dtype
    (a numpy type string), shape, chunks and order, zstd or uncompressed
    chunks, a missing chunk read as the fill value (null: zeros)."""
    where = f"{what}:{name}"
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise ValueError(f"{where}: no zarr array (.zarray)") from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {meta.get('zarr_format')} is not supported")
    if meta.get("filters"):
        raise ValueError(f"{where}: zarr filters are not supported")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd"):
        raise ValueError(f"{where}: zarr compressor {meta.get('compressor')} is not "
                         f"supported (orbax writes zstd, the port none)")
    try:
        stored = np.dtype(meta["dtype"])
    except TypeError:
        raise ValueError(f"{where}: zarr dtype {meta['dtype']!r} is not supported") from None
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, stored)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid) if shape else [()]:
        key = f"{name}/" + (sep.join(str(i) for i in idx) if idx else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if key not in store:
            out[region] = _fill(stored, meta.get("fill_value"))
            continue
        raw = store.read(key)
        data = (zstd.decompress(raw, f"{what}:{key}") if compressor
                else np.frombuffer(raw, np.uint8))
        want = int(np.prod(chunks, dtype=np.int64)) * stored.itemsize
        if data.nbytes != want:
            raise ValueError(f"{what}:{key}: chunk holds {data.nbytes} bytes, "
                             f"{want} expected")
        chunk = data.view(stored).reshape(chunks, order=order)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def read_orbax_tree(path: str, skip=()) -> dict:
    """A ``PyTreeCheckpointHandler`` directory's tree, but for the
    top-level subtrees named in ``skip`` → nested dicts of numpy arrays
    (scalars as 0-d arrays).  Above ``_POOL_BYTES`` of stored data the
    leaves are read on a thread pool (``ctypes`` drops the GIL while zstd
    decodes)."""
    path = os.path.abspath(str(path))
    try:
        with open(os.path.join(path, "_METADATA")) as fh:
            tree_meta = json.load(fh)
    except FileNotFoundError:
        raise ValueError(f"{path}: no _METADATA (not an orbax PyTree checkpoint)") from None
    if not tree_meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: an orbax checkpoint without OCDBT is not supported")
    if tree_meta.get("use_zarr3", False):
        raise ValueError(f"{path}: an orbax checkpoint in zarr v3 is not supported")
    leaves = []
    for entry in tree_meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if not keys or keys[0] in skip or value.get("skip_deserialize"):
            continue
        if value.get("value_type") not in _ARRAY_TYPES:
            continue
        leaves.append(keys)
    with OcdbtStore(path) as store:
        # a pool pays for its threads above a few MB
        stored = sum(store.value_size(k) for k in store.keys()
                     if k.split(b".", 1)[0].decode(errors="replace") not in skip)
        workers = min(len(leaves), os.cpu_count() or 1, 16) if stored > _POOL_BYTES else 1

        def read(keys):
            return read_zarr_array(store, ".".join(keys), path)

        if workers <= 1:
            arrays = [read(keys) for keys in leaves]
        else:
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                arrays = list(pool.map(read, leaves))
    tree: Dict[str, Any] = {}
    for keys, arr in zip(leaves, arrays):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def load_checkpoint_orbax(path: str, layout: Optional[pytreedef.OptaxLayout] = None,
                          log=print) -> Tuple[dict, dict]:
    """A ``.orbax`` directory → (the ``model`` tree of numpy arrays, meta),
    as the JAX ``load_checkpoint_orbax`` returns them: epoch and global
    step as ints, ``stats`` unpickled from ``meta.stats_pickle``, the
    occupancy entries of ``meta``.  With ``layout`` (the JAX trainer's optax
    state for this field, ``pytreedef.optax_layout``) the ``optimizer``
    subtree is read too and restored as the JAX loader restores it:
    ``meta[TORCH_OPTIMIZER_KEY]`` then holds ``adam`` (``step``,
    ``exp_avg`` and ``exp_avg_sq`` by parameter name), ``n_updates`` (the
    optax count) and ``found_nan`` (flax path → bool).  A treedef or
    leaves that are not ``layout``'s leave it out, after the JAX loader's
    ``[WARN] failed to restore orbax optimizer state`` line."""
    tree = read_orbax_tree(path, skip=() if layout is not None else ("optimizer",))
    raw = tree.get("meta", {})
    meta = {"epoch": int(raw.get("epoch", 0)),
            "global_step": int(raw.get("global_step", 0)),
            "stats": (pickle.loads(np.asarray(raw["stats_pickle"], np.uint8).tobytes())
                      if "stats_pickle" in raw else {})}
    for k in OCC_ARRAY_KEYS + OCC_SCALAR_KEYS:
        if k in raw:
            meta[k] = raw[k]
    if "model" not in tree:
        raise ValueError(f"{path}: the orbax checkpoint has no 'model' subtree")
    if "optimizer" in tree:
        try:
            opt = tree["optimizer"]
            nodes = pytreedef.loads_treedef(np.asarray(opt["treedef"], np.uint8).tobytes())
            leaves = [opt["leaves"][str(i)] for i in range(len(opt["leaves"]))]
            adam = pytreedef.leaves_to_adam(layout, nodes, leaves)
        except (ValueError, KeyError, TypeError) as e:   # the JAX loader's failed restore
            log(f"[WARN] failed to restore orbax optimizer state: {path}: {e}")
        else:
            meta[TORCH_OPTIMIZER_KEY] = {
                "adam": {"step": torch.tensor(float(adam["count"])),
                         "exp_avg": params_from_flax(adam["mu"]),
                         "exp_avg_sq": params_from_flax(adam["nu"])},
                "n_updates": adam["count"], "found_nan": adam["found_nan"]}
    return tree["model"], meta


def orbax_state(params, epoch: int, global_step: int, stats: dict,
                optimizer: Optional[Tuple[bytes, list]] = None,
                extra: Optional[dict] = None) -> Dict[str, Any]:
    """The tree the JAX ``OrbaxSaver.save`` (:198-220) saves: ``meta``
    (epoch, global step, the pickled stats, the occupancy ``extra``),
    ``model`` (the flax tree) and, given ``optimizer`` = (pickled treedef,
    leaves in flatten order), ``optimizer``."""
    state: Dict[str, Any] = {
        "meta": {"epoch": int(epoch), "global_step": int(global_step),
                 "stats_pickle": np.frombuffer(pickle.dumps(stats), np.uint8)},
        "model": params}
    if optimizer is not None:
        treedef, leaves = optimizer
        state["optimizer"] = {"leaves": {str(i): v for i, v in enumerate(leaves)},
                              "treedef": np.frombuffer(treedef, np.uint8)}
    if extra:
        state["meta"].update(extra)
    return state


_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


def _zarr_leaf(name: str, value, entries: dict) -> str:
    """Put ``value`` (a numpy array, or an int / float stored as orbax
    stores a Python scalar: a 0-d int64 / float64) into ``entries`` as the
    zarr v2 array ``name``: one uncompressed chunk, C order.  Returns its
    orbax value type."""
    if isinstance(value, (bool, np.bool_)) or not isinstance(value, (int, float, np.ndarray)):
        raise TypeError(f"{name}: a {type(value).__name__} is not a checkpoint leaf")
    kind = "np.ndarray" if isinstance(value, np.ndarray) else "scalar"
    a = (value if kind == "np.ndarray" else
         np.array(value, np.int64 if isinstance(value, int) else np.float64))
    a = a if a.flags.c_contiguous else a.copy()       # (ascontiguousarray makes 0-d 1-d)
    zarray = {"chunks": list(a.shape), "compressor": None, "dimension_separator": ".",
              "dtype": a.dtype.str, "fill_value": None, "filters": None,
              "order": "C", "shape": list(a.shape), "zarr_format": 2}
    entries[f"{name}/.zarray"] = json.dumps(zarray, sort_keys=True,
                                            separators=(",", ":")).encode()
    entries[f"{name}/" + (".".join("0" * a.ndim) if a.ndim else "0")] = \
        a.reshape(-1).view(np.uint8)
    return kind


def write_orbax_tree(path: str, tree: dict) -> int:
    """Write ``tree`` (nested dicts of numpy arrays and Python scalars) as a
    ``PyTreeCheckpointHandler`` directory at ``path``, which orbax's restore
    and the JAX ``load_checkpoint_orbax`` read: ``_METADATA``, an OCDBT
    store of zarr v2 arrays (``engine/ocdbt.py::write_store``) and
    ``_CHECKPOINT_METADATA``, each file fsynced, written into a temporary
    sibling (``<path>.orbax-checkpoint-tmp-<ns>``, as orbax names it) that
    replaces ``path`` by a rename once complete.  Returns the bytes
    written."""
    path = os.path.abspath(str(path))
    start = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{start}"
    entries: Dict[str, Any] = {}
    tree_meta: Dict[str, Any] = {}

    def walk(node, keys):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, keys + (str(k),))
                continue
            kk = keys + (str(k),)
            kind = _zarr_leaf(".".join(kk), v, entries)
            tree_meta[str(kk)] = {
                "key_metadata": [{"key": x, "key_type": 2} for x in kk],
                "value_metadata": {"value_type": kind, "skip_deserialize": False}}

    walk(tree, ())
    try:
        os.makedirs(tmp)
        written = write_store(tmp, entries)
        for name, obj in (
                ("_METADATA", {"tree_metadata": tree_meta, "use_ocdbt": True,
                               "use_zarr3": False,
                               "store_array_data_equal_to_fill_value": True,
                               "custom_metadata": None}),
                ("_CHECKPOINT_METADATA", {"item_handlers": _HANDLER, "metrics": {},
                                          "performance_metrics": {},
                                          "init_timestamp_nsecs": start,
                                          "commit_timestamp_nsecs": time.time_ns(),
                                          "custom_metadata": {}})):
            data = json.dumps(obj).encode()
            with open(os.path.join(tmp, name), "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            written += len(data)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return written
