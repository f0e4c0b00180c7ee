"""Find what the benchmark holds by name, from files: ``BENCHMARK.json`` at
the root, ``configs/<config>.json`` (each named by the entry's ``file``),
``traffic/<traffic>.json``, ``limits/<cell>.json`` (the limits of
``correct``), ``jobs/<job>.py`` (the traffic file's ``job``: what a kind of
step builds and its plain reference) and ``metrics/<metric>.py`` (a
per-layer reader with ``read(traced)``).  A cell, a configuration, a
traffic mix, a job or a metric is added by adding its files and its entry;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names(sub: str, ext: str) -> list:
    d = os.path.join(HERE, sub)
    return sorted(f[:-len(ext)] for f in os.listdir(d) if f.endswith(ext))


def configs() -> list:
    return _names("configs", ".json")


def traffics() -> list:
    return _names("traffic", ".json")


def metrics() -> list:
    return _names("metrics", ".py")


def jobs() -> list:
    return [n for n in _names("jobs", ".py") if not n.startswith("_")]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str, root: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return load_json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def _module(sub: str, name: str):
    path = os.path.join(HERE, sub, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{sub}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def job(name: str):
    """The module ``jobs/<name>.py``."""
    return _module("jobs", name)


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    whose ``workloads`` list it, and those without such a list."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
