"""A copy of the benchmark at a size the CPU holds: the same
BENCHMARK.json, configuration, mix and metric files, with a 300 kb genome
core, 3,000 pairs a pass and device chunks of 256 pairs, mapped with the
kernels' plain versions (--torch-device cpu)."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BASE = os.path.dirname(HERE)
ROOT = os.path.dirname(BASE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_PAIRS = 3000


def make_tiny(root: str) -> str:
    """Write the small copy under `root`; returns `root`."""
    base = os.path.join(root, os.path.basename(BASE))
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BASE, sub), os.path.join(base, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for name in os.listdir(os.path.join(base, "configs")):
        path = os.path.join(base, "configs", name)
        with open(path) as f:
            conf = json.load(f)
        conf["genome"]["genome_core"] = 300_000
        conf["options"]["device_batch_size"] = 256
        with open(path, "w") as f:
            json.dump(conf, f)
    for name in os.listdir(os.path.join(base, "traffic")):
        if not name.endswith(".json"):
            continue
        path = os.path.join(base, "traffic", name)
        with open(path) as f:
            mix = json.load(f)
        total = sum(lane["pairs"] for lane in mix["lanes"])
        # the same lanes in proportion, whole device chunks in the first
        lanes, left = [], TINY_PAIRS
        for lane in mix["lanes"][:-1]:
            pairs = 256 * max(3, round(TINY_PAIRS * lane["pairs"]
                                       / total / 256))
            lanes.append({**lane, "pairs": pairs})
            left -= pairs
        lanes.append({**mix["lanes"][-1], "pairs": left})
        mix["lanes"] = lanes
        with open(path, "w") as f:
            json.dump(mix, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("portbench")))
