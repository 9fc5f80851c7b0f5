"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its `file`) and a traffic mix (the file
`traffic/<mix>.json` of this folder, whose `generator` names a module
`traffic/<generator>.py`); a per-layer metric is read by
`metrics/<metric>.py`. Adding a configuration, a mix or a metric is adding
its file and its entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))


class Spec:
    """The benchmark file at `root`/BENCHMARK.json, with this folder's
    layout under `root`."""

    def __init__(self, root: str = os.path.dirname(HERE)):
        self.root = root
        self.base = os.path.join(root, os.path.basename(HERE))
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return {**json.load(f), "name": name}
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        with open(os.path.join(self.base, "traffic", name + ".json")) as f:
            return {**json.load(f), "name": name}

    def generator(self, mix: dict) -> ModuleType:
        return _load(os.path.join(self.base, "traffic",
                                  mix["generator"] + ".py"))

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics
        with --trace 0, its per-layer ones with --trace 1."""
        ends = [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]
        if not trace:
            return ends
        moved = {m["name"] for m in ends}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]

    def reader(self, metric: str) -> ModuleType:
        return _load(os.path.join(self.base, "metrics", metric + ".py"))


def _load(path: str) -> ModuleType:
    name = "portbench_file_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
