"""The JAX trainer's optax state as JAX pickles it, read and written without
JAX or optax (counterpart of the ``optimizer`` subtree that
``customnerf_tpu/engine/checkpoint.py::OrbaxSaver.save`` writes and
``load_checkpoint_orbax`` restores).

The JAX package stores its Adam state as ``leaves`` (``jax.tree_util``'s
flatten order) and ``treedef``, ``pickle.dumps`` of the state's
``PyTreeDef``.  That pickle is ``PyTreeDef.__new__`` followed by
``__setstate__((default_registry, nodes))``; ``nodes`` lists the tree's
nodes in post-order, each a tuple

    (kind, arity, node data, custom type, leaves below, nodes below)

with kinds 0 leaf, 2 tuple, 3 namedtuple (node data: the class), 5 dict
(node data: the sorted keys); the custom type is None for these, and the
two counts include the node itself.  Classes are pickled by name
(``_CLASSES``): a reader that imported them would need JAX and optax, and
unpickling runs whatever a pickle names.  :func:`loads_treedef` therefore
uses an unpickler whose ``find_class`` hands out inert stand-ins for
exactly those names and raises ``ValueError`` on any other, importing
nothing; :func:`dumps_treedef` writes the pickle opcodes itself.

The JAX trainer's optimizer (``customnerf_tpu/engine/trainer.py:166-185``)
is ``multi_transform({"grid": adam(sched(10)), "mlp": adam(sched(1))})``
labelling ``grid_table`` "grid" and the rest "mlp", each ``adam`` being
``chain(zero_nans, scale_by_adam, scale_by_learning_rate)`` with
``add_decayed_weights`` chained in front under ``--weight_decay``.  Its
state is ``PartitionState(inner_states={label: MaskedState(inner_state=
chain state)})``; within a label every parameter of the other label is a
``MaskedNode``.  :func:`optax_layout` builds that structure for a field's
flax tree and names each leaf's role: a parameter's ``found_nan``, a
label's Adam ``count``, a parameter's ``mu`` / ``nu``, a label's schedule
``count``.
"""

from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

LEAF, TUPLE, NAMEDTUPLE, DICT = 0, 2, 3, 5

_TREEDEF = ("jaxlib._jax.pytree", "PyTreeDef")
_REGISTRY = ("jax._src.tree_util", "default_registry")
_MASKING = "optax.transforms._masking"
# the state's namedtuple classes by (module, name), as JAX 0.9 and optax
# 0.2.6 pickle them
_CLASSES = (
    ("optax.transforms._combining", "PartitionState"),      # (inner_states,)
    (_MASKING, "MaskedState"),                              # (inner_state,)
    (_MASKING, "MaskedNode"),                               # ()
    ("optax.transforms._constraining", "ZeroNansState"),    # (found_nan,)
    ("optax._src.transform", "ScaleByAdamState"),           # (count, mu, nu)
    ("optax._src.transform", "ScaleByScheduleState"),       # (count,)
    ("optax._src.base", "EmptyState"),                      # add_decayed_weights'
)
_CLASS = {key[1]: key for key in _CLASSES}
LABELS = ("grid", "mlp")


@dataclass(frozen=True)
class Node:
    """One entry of a treedef's post-order node list; ``data`` is None, a
    dict's sorted keys (a tuple) or a namedtuple's (module, name)."""
    kind: int
    arity: int
    data: object
    leaves: int
    nodes: int


# ------------------------------------------------------------------ reading
class _Stand:
    """An inert stand-in for a pickled class or object: its name only."""
    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


class _TreeDef:
    """Takes the place of ``PyTreeDef``: keeps the state it is given."""

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        key = (module, name)
        if key == _TREEDEF:
            return _TreeDef
        if key == _REGISTRY or key in _CLASSES:
            return _Stand(key)
        raise ValueError(f"the optimizer treedef names {module}.{name}, which is "
                         f"not a JAX/optax name of the JAX trainer's optax state")

    def persistent_load(self, pid):
        raise ValueError("the optimizer treedef holds a persistent id")


def loads_treedef(data: bytes) -> List[Node]:
    """The node list of a pickled JAX ``PyTreeDef``, unpickled without
    JAX: only the names of ``_CLASSES``, the registry and ``PyTreeDef`` are
    accepted (ValueError on any other, before anything is called)."""
    try:
        obj = _Unpickler(io.BytesIO(bytes(data))).load()
    except ValueError:
        raise
    except Exception as e:          # a malformed pickle
        raise ValueError(f"the optimizer treedef is not a readable pickle: {e!r}") from e
    state = getattr(obj, "state", None) if isinstance(obj, _TreeDef) else None
    if not (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[0], _Stand) and state[0].key == _REGISTRY
            and isinstance(state[1], list)):
        raise ValueError("the optimizer treedef is not a pickled PyTreeDef of "
                         "JAX's default registry")
    nodes = []
    for t in state[1]:
        if not (isinstance(t, tuple) and len(t) == 6 and t[3] is None
                and all(type(v) is int for v in (t[0], t[1], t[4], t[5]))):
            raise ValueError(f"node {len(nodes)} of the optimizer treedef is not "
                             f"a (kind, arity, data, None, leaves, nodes) tuple")
        kind, arity, data = t[0], t[1], t[2]
        if kind == NAMEDTUPLE and isinstance(data, _Stand) and data.key in _CLASSES:
            data = data.key
        elif kind == DICT and isinstance(data, list) and all(
                isinstance(k, str) for k in data):
            data = tuple(data)
        elif kind not in (LEAF, TUPLE) or data is not None:
            raise ValueError(f"node {len(nodes)} of the optimizer treedef: kind "
                             f"{kind} with data {type(data).__name__} is not read")
        nodes.append(Node(kind, arity, data, t[4], t[5]))
    return nodes


# ------------------------------------------------------------------ writing
def _op_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) < 256:
        return b"\x8c" + bytes([len(b)]) + b              # SHORT_BINUNICODE
    return b"X" + struct.pack("<I", len(b)) + b           # BINUNICODE


def _op_int(v: int) -> bytes:
    if 0 <= v < 256:
        return b"K" + bytes([v])                          # BININT1
    if 0 <= v < 65536:
        return b"M" + struct.pack("<H", v)                # BININT2
    return b"J" + struct.pack("<i", v)                    # BININT


def dumps_treedef(nodes: List[Node]) -> bytes:
    """The pickle of a ``PyTreeDef`` with these nodes, as protocol-4
    opcodes: ``pickle.loads`` under JAX rebuilds the treedef.  Each class is
    named once and fetched from the memo after that."""
    out = [b"\x80\x04"]                                   # PROTO 4
    memo: Dict[Tuple[str, str], int] = {}

    def glob(key):
        if key in memo:
            i = memo[key]
            out.append(b"h" + bytes([i]) if i < 256 else b"j" + struct.pack("<I", i))
            return
        out.extend([_op_str(key[0]), _op_str(key[1]), b"\x93", b"\x94"])
        memo[key] = len(memo)                             # STACK_GLOBAL, MEMOIZE

    glob(_TREEDEF)
    out.append(b")\x81")                                  # EMPTY_TUPLE, NEWOBJ
    glob(_REGISTRY)
    out.append(b"]")                                      # EMPTY_LIST
    if nodes:
        out.append(b"(")                                  # MARK
        for n in nodes:
            out.extend([b"(", _op_int(n.kind), _op_int(n.arity)])
            if n.kind == NAMEDTUPLE:
                glob(n.data)
            elif n.kind == DICT:
                out.append(b"]")
                if n.data:
                    out.append(b"(")
                    out.extend(_op_str(k) for k in n.data)
                    out.append(b"e")                      # APPENDS
            else:
                out.append(b"N")
            out.extend([b"N", _op_int(n.leaves), _op_int(n.nodes), b"t"])
        out.append(b"e")                                  # APPENDS
    out.append(b"\x86b.")                                 # TUPLE2, BUILD, STOP
    return b"".join(out)


# ------------------------------------------------------ the trainer's state
@dataclass(frozen=True)
class OptaxLayout:
    """The JAX trainer's optax state for one field: its nodes and, for each
    leaf in flatten order, its role ``(what, label, path)``: ``found_nan``,
    ``mu`` and ``nu`` name a parameter's dotted flax path (``params.
    grid_table``); ``count`` and ``schedule`` name no path.  ``shapes``:
    each path's shape."""
    nodes: Tuple[Node, ...]
    roles: Tuple[Tuple[str, str, str], ...]
    shapes: Dict[str, Tuple[int, ...]]


def shapes_of(tree: dict) -> Dict[str, Tuple[int, ...]]:
    """Dotted path → shape of a flax tree's leaves (arrays)."""
    return {k: tuple(np.shape(v)) for k, v in _flat(tree)}


def optax_layout(shapes: Dict[str, Tuple[int, ...]],
                 weight_decay: bool = False) -> OptaxLayout:
    """The layout of the JAX trainer's optax state for the flax tree whose
    leaves' dotted paths and shapes are ``shapes`` (``params.grid_table``:
    :func:`shapes_of`), with the ``add_decayed_weights`` chain under
    ``weight_decay``."""
    params = _unflatten(shapes)
    nodes: List[Node] = []
    roles: List[Tuple[str, str, str]] = []

    def emit(kind, arity, data, children):
        """children: callables that emit a child and return (leaves, nodes)."""
        leaves, n = int(kind == LEAF), 0
        for child in children:
            cl, cn = child()
            leaves, n = leaves + cl, n + cn
        nodes.append(Node(kind, arity, data, leaves, n + 1))
        return leaves, n + 1

    def leaf(role):
        def f():
            roles.append(role)
            return emit(LEAF, 0, None, [])
        return f

    def named(name, *children):
        return lambda: emit(NAMEDTUPLE, len(children), _CLASS[name], children)

    def masked_tree(tree, label, what, prefix=()):
        keys = tuple(sorted(tree))

        def child(k):
            v, path = tree[k], prefix + (k,)
            if isinstance(v, dict):
                return masked_tree(v, label, what, path)
            mine = ("grid" if "grid_table" in path else "mlp") == label
            return leaf((what, label, ".".join(path))) if mine else named("MaskedNode")

        return lambda: emit(DICT, len(keys), keys, [child(k) for k in keys])

    def chain(label):
        def inner():
            return emit(TUPLE, 3, None, [
                named("ZeroNansState", masked_tree(params, label, "found_nan")),
                named("ScaleByAdamState", leaf(("count", label, "")),
                      masked_tree(params, label, "mu"), masked_tree(params, label, "nu")),
                named("ScaleByScheduleState", leaf(("schedule", label, "")))])
        if not weight_decay:
            return inner
        return lambda: emit(TUPLE, 2, None, [named("EmptyState"), inner])

    emit(NAMEDTUPLE, 1, _CLASS["PartitionState"], [
        lambda: emit(DICT, len(LABELS), LABELS,
                     [named("MaskedState", chain(label)) for label in LABELS])])
    return OptaxLayout(tuple(nodes), tuple(roles), dict(shapes))


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, last = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def leaves_to_adam(layout: OptaxLayout, nodes: List[Node], leaves) -> dict:
    """Stored (nodes, leaves) → ``{"mu", "nu"}`` flax trees (float32),
    ``count`` (int) and ``found_nan`` (``{path: bool}``).  Raises ValueError
    when the nodes are not ``layout``'s, a leaf's shape or dtype is not its
    role's, or the labels' and schedules' counts differ."""
    want = list(layout.nodes)
    if len(nodes) != len(want):
        raise ValueError(f"the treedef has {len(nodes)} nodes; the field's optax "
                         f"state has {len(want)}")
    for i, (got, exp) in enumerate(zip(nodes, want)):
        if got != exp:
            raise ValueError(f"treedef node {i} is {got}; the field's optax state "
                             f"has {exp} there")
    if len(leaves) != len(layout.roles):
        raise ValueError(f"{len(leaves)} optimizer leaves for a treedef of "
                         f"{len(layout.roles)}")
    moments: Dict[str, Dict[str, np.ndarray]] = {"mu": {}, "nu": {}}
    counts, found_nan = [], {}
    for i, ((what, _, path), leaf) in enumerate(zip(layout.roles, leaves)):
        a = np.asarray(leaf)
        shape, dtype = {"found_nan": ((), np.bool_), "count": ((), np.int32),
                        "schedule": ((), np.int32)}.get(
            what, (layout.shapes.get(path), np.float32))
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"optimizer leaf {i} ({what} {path}) is {a.dtype}"
                             f"{list(a.shape)}; {np.dtype(dtype)}{list(shape)} expected")
        if what in moments:
            moments[what][path] = a
        elif what == "found_nan":
            found_nan[path] = bool(a)
        else:
            counts.append(int(a))
    if len(set(counts)) != 1:
        raise ValueError(f"the optax labels' and schedules' counts differ: {counts}")
    return {"mu": _unflatten(moments["mu"]), "nu": _unflatten(moments["nu"]),
            "count": counts[0], "found_nan": found_nan}


def adam_to_leaves(layout: OptaxLayout, mu: dict, nu: dict, count: int,
                   found_nan=None) -> List[np.ndarray]:
    """The leaves of ``layout``'s state in flatten order: ``mu`` / ``nu``
    flax trees, every count ``count`` (int32) and each parameter's
    ``found_nan`` from ``{path: bool}`` (False where absent)."""
    flat = {"mu": dict(_flat(mu)), "nu": dict(_flat(nu))}
    found_nan = found_nan or {}
    out = []
    for what, _, path in layout.roles:
        if what in flat:
            out.append(flat[what][path])
        elif what == "found_nan":
            out.append(np.array(bool(found_nan.get(path, False))))
        else:
            out.append(np.array(count, np.int32))
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v
