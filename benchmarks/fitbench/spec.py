"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics.  Everything that
belongs to one of them sits in a file of its own under ``benchmarks/``,
found by its name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``),
* a traffic mix: ``traffic/<name>.json``, the fit schedule one general
  loop runs back to back,
* a per-layer metric: ``metrics/<name>.py``, a reader with
  ``read(ctx) -> float | None``,
* the operations and bytes of a stage or kernel: ``counts/<name>.py``,
* a configuration's plain reference: the file its ``reference`` key
  names, relative to the checkout's root, which exports
  ``posterior_mean(Y, model, schedule, seed, chains, device, *, dtype)
  -> (panels, prepared)`` with ``fitref/gibbs.py``'s meaning and imports
  only ``numpy``, ``torch``, the standard library and ``fitref``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module of its own (metric and count
    files have dots in their names, so they are loaded by path), entered
    in ``sys.modules`` as ``name`` before it runs: a dataclass defined in
    it looks its module up there."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell, its configuration, its traffic and its metrics."""
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, listing none,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     entry["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(entry["chips"]), config, traffic, e2e, layer)


def metric_reader(name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       "fitbench_metric_" + name.replace(".", "_"))


def counts(name: str):
    return load_module(os.path.join(BENCH_DIR, "counts", name + ".py"),
                       "fitbench_counts_" + name.replace(".", "_"))
