"""Find a cell's pieces by name, from files alone.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, the DSL recipe that a mix names
``algorithms/<algorithm>.py``, its plain reference ``reference/<algorithm>.py``
and a per-layer metric's reader ``metrics/<metric>.py``.  A later change adds
a file and an entry of ``BENCHMARK.json``; it edits none of these.
"""

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name):
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark(root=ROOT):
    """``BENCHMARK.json`` of the checkout."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(folder, name):
    path = os.path.join(HERE, folder, _checked(name) + ".json")
    with open(path) as f:
        return json.load(f)


def config(name):
    return _json("configs", name)


def traffic(name):
    return _json("traffic", name)


def _module(folder, name):
    """The module in ``<folder>/<name>.py``, loaded from its file (a metric's
    name holds dots, so it is no importable module name)."""
    path = os.path.join(HERE, folder, _checked(name) + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"gbbench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def algorithm(name):
    return _module("algorithms", name)


def reference(name):
    return _module("reference", name)


def metric(name):
    return _module("metrics", name)


def cell(name, root=ROOT):
    """(workload entry, config, traffic, the per-layer and end-to-end metric
    entries that the cell reports) of the cell ``name``."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return (
        w,
        config(w["config"]),
        traffic(w["traffic"]),
        [m for m in bench["per_layer"] if reports(m)],
        [m for m in bench["end_to_end"] if reports(m)],
    )
