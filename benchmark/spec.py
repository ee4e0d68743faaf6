"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` resolves to its configuration's file (the
``file`` of its ``configs`` entry), its traffic mix
(``benchmark/traffic/<traffic>.json``), the request kind that mix names
(``benchmark/requests/<request>.py``), its limits
(``benchmark/limits/<cell>.json``), each end-to-end metric's reader
(``benchmark/end_to_end/<name>.py``) and each per-layer metric's
(``benchmark/metrics/<name>.py``).  A later cell, mix, request kind or
metric is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    name = "benchmark._loaded." + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict         # the configuration's file
    config_entry: dict   # its entry in BENCHMARK.json
    traffic: dict        # the traffic mix's file
    limits: dict         # the cell's limits file
    end_to_end: list     # the entries of the metrics this cell reports
    per_layer: list

    def request_module(self):
        return load_module(os.path.join(HERE, "requests",
                                        self.traffic["request"] + ".py"))


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Spec:
    """``BENCHMARK.json`` at ``root``."""

    def __init__(self, root: str):
        self.root = root
        self.data = _read_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> Cell:
        entries = {w["name"]: w for w in self.data["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                           f"{sorted(entries)}")
        w = entries[name]
        configs = {c["name"]: c for c in self.data["configs"]}
        entry = configs[w["config"]]
        return Cell(
            name=name, chips=int(w["chips"]),
            config=_read_json(os.path.join(self.root, entry["file"])),
            config_entry=entry,
            traffic=_read_json(os.path.join(HERE, "traffic",
                                            w["traffic"] + ".json")),
            limits=_read_json(os.path.join(HERE, "limits", name + ".json")),
            end_to_end=[m for m in self.data["end_to_end"]
                        if _applies(m, name)],
            per_layer=[m for m in self.data["per_layer"]
                       if _applies(m, name)])

    @staticmethod
    def metric_module(name: str):
        """A per-layer metric's reader: ``read(m)`` of the traced run."""
        return load_module(os.path.join(HERE, "metrics", name + ".py"))

    @staticmethod
    def end_to_end_module(name: str):
        """An end-to-end metric's reader: ``read(values)`` of the window."""
        return load_module(os.path.join(HERE, "end_to_end", name + ".py"))
