"""A copy of the benchmark at a size the CPU holds: the same
BENCHMARK.json and the same files of every folder that `Spec` finds by
name (configurations, mixes and their generators, metric readers, output
checks), with a 300 kb genome core, 3,000 pairs a pass and device chunks
of 256 pairs, mapped with the kernels' plain versions (--torch-device
cpu)."""

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

from portbench.spec import NAMED_FOLDERS  # noqa: E402

TINY_PAIRS = 3000


def make_tiny(root: str, src: str = ROOT) -> str:
    """Write the small copy of the benchmark at `src` (a root holding
    BENCHMARK.json and this folder) under `root`; returns `root`."""
    folder = os.path.basename(BASE)
    base = os.path.join(root, folder)
    for sub in NAMED_FOLDERS:
        if os.path.isdir(os.path.join(src, folder, sub)):
            shutil.copytree(os.path.join(src, folder, sub),
                            os.path.join(base, sub),
                            ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(src, "BENCHMARK.json"), root)
    for name in os.listdir(os.path.join(base, "configs")):
        path = os.path.join(base, "configs", name)
        with open(path) as f:
            conf = json.load(f)
        conf["genome"]["genome_core"] = 300_000
        conf.setdefault("options", {})["device_batch_size"] = 256
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
