"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

- a configuration: the file its entry names (``configs/<name>.json``) and
  its plain reference, ``reference/<name>.py``;
- a traffic mix: ``workloads/<traffic>.json``;
- a cell's correctness limits: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<name>.py``, a ``read(ctx)``;
- a hand kernel: ``kernels/<name>.py``, a name ``PATTERN`` and a
  ``work(cell)``.

A later cell, configuration, metric or kernel count is a new file under
these directories and an entry in ``BENCHMARK.json``: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at `path` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark._loaded." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # the configuration file
    traffic: dict        # the traffic file
    limits: dict         # {compared number: limit}
    end_to_end: list     # the end-to-end metric entries this cell reports
    per_layer: list      # the per-layer metric entries this cell reports
    here: str            # the benchmark's directory
    root: str            # the checkout's root

    def reference(self):
        return load_module(os.path.join(self.here, "reference",
                                        self.config["name"] + ".py"),
                           "reference_" + self.config["name"])

    def metric(self, name: str):
        return load_module(os.path.join(self.here, "metrics", name + ".py"),
                           "metric_" + name)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def kernels(here: str = HERE) -> dict:
    """{kernel name: module} of every file under ``kernels/``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(here, "kernels", "*.py"))):
        name = os.path.basename(path)[:-3]
        if not name.startswith("_"):
            out[name] = load_module(path, "kernel_" + name)
    return out


def cell(name: str, root: str = ROOT, here: str = HERE,
         bench: dict | None = None) -> Cell:
    """The cell `name` of ``<root>/BENCHMARK.json`` (or of `bench`)."""
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(entries)}")
    entry = entries[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(os.path.join(root, confs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(here, "workloads",
                                     entry["traffic"] + ".json"))
    limits_path = os.path.join(here, "limits", name + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(name=name, entry=entry, config=conf, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                here=here, root=root)
