"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its `file`) and a traffic mix (the file
`traffic/<mix>.json` of this folder, whose `generator` names a module
`traffic/<generator>.py`); a per-layer metric is read by
`metrics/<metric>.py`. Adding a configuration, a mix or a metric is adding
its file and its entry: nothing here changes.

What a configuration may bring, each as files of its own:
- a generator (`traffic/<generator>.py`, named by its mix), whose
  `write_lanes(out_dir, fasta, mix, seed)` returns one dict a lane: the
  mates `r1`, `r2` and the lane's `pairs`, and optionally a barcode read
  `bc` (in every lane or in none) and a barcode `whitelist` (the same file
  in every lane). The harness hands `bc` to the program as its `-b` files
  (a single-cell run) and `whitelist` as its `--barcode-whitelist`.
- an output check (`checks/<name>.py`, named by the configuration's
  `"check": "<name>"`): `check(conf, fasta, index_dir, lanes, out_path,
  seed)` returns (checks, info), `checks` a count of lines or pairs at
  fault for each name, each with limit 0, always with
  `compared_under_half` and `output_absent`. A check module may import
  and wrap `portbench/reference/` (the plain reference) and brings any
  reference it needs besides as new files. A configuration with no
  `"check"` is judged by `reference/check.py`.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
# the folders whose files are found by a name in BENCHMARK.json, a mix or
# a configuration
NAMED_FOLDERS = ("configs", "traffic", "metrics", "checks")


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

    def checker(self, conf: dict) -> ModuleType:
        """The module whose `check` judges a run of configuration `conf`:
        `checks/<conf["check"]>.py`, or `reference/check.py`."""
        if "check" in conf:
            return _load(os.path.join(self.base, "checks",
                                      conf["check"] + ".py"))
        return importlib.import_module("portbench.reference.check")

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
