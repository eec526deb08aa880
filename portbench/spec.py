"""Where the harness finds what ``BENCHMARK.json`` names.

A cell (an entry of ``workloads``) is ``workloads/<cell>.json``; its
configuration ``configs/<config>.json``; a per-layer metric the reader
``metrics/<metric>.py``; the kind of call a cell drives ``entries/<entry>.py``.
Adding any of them is adding a file: nothing here lists them.

A configuration's ``family`` says what its data are: "functional" (the
default where the file has none), curves on a cubic B-spline basis of P
functions on [0, 1]; or "hd", surfaces on a tensor-product basis given by
``basis_degrees`` (one an axis), ``internal_knots`` (a list an axis) and
``boundary_knots`` ([lo, hi] an axis), whose column count P has to be.
Every family keeps the sizes N, K, P, M, D and ``n_time`` = [min, max]
points an observation, with the meaning the FLOP counts and the kernels'
readers give them.  ``datagen.from_config`` checks the family and makes
its data; the reference (``reference.model.Curves.from_raw``) and the
program (``entries/common.py``) build their bases and nu's penalty from
what it made.  Any other family is refused with a ValueError.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """(bench, cell, config): the cell's entry of ``BENCHMARK.json`` merged
    with its file, and its configuration's file.  Raises KeyError for a
    cell that ``BENCHMARK.json`` does not name and ValueError where the
    cell's file disagrees with it."""
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[name]
    here = Path(root) / "portbench"
    cell = _load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{cell.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    cell = dict(cell, name=name, chips=entry["chips"], why=entry["why"])
    config = dict(_load_json(here / "configs" / f"{entry['config']}.json"),
                  name=entry["config"])
    return bench, cell, config


def metrics_of(bench, cell_name, kind):
    """The entries of ``bench[kind]`` ("end_to_end" or "per_layer") that
    the cell reports: those whose ``workloads`` name it, or that have no
    ``workloads`` key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric_name, root=ROOT):
    """The module ``metrics/<metric_name>.py``; its ``read(ctx)`` returns
    the metric's value or None where it finds nothing to read."""
    path = Path(root) / "portbench" / "metrics" / f"{metric_name}.py"
    return _load_module(path, "portbench_metric_" + metric_name
                        .replace(".", "_"))


def load_entry(entry_name, root=ROOT):
    """The module ``entries/<entry_name>.py``, which defines ``Entry``."""
    path = Path(root) / "portbench" / "entries" / f"{entry_name}.py"
    return _load_module(path, "portbench_entry_" + entry_name)
