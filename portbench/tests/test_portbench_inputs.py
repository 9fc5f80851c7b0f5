"""A configuration that brings its own inputs and its own output check is
added as new files alone: a copy of the benchmark gets a fourth
configuration (`--preset chip`, judged by `checks/probe.py`), a mix whose
generator (`traffic/barcoded_reads.py`) writes a 10x-style barcode read
for each lane and a whitelist, and a cell of the two; conftest.py's
`make_tiny` shrinks it as it shrinks the cells it knows, and `run_cell`
maps the barcoded pairs against the whitelist and hands the lanes to the
named check. A check is resolved before the mapping, and what it loads
counts in the run's scan for the JAX package. The three real
configurations keep `reference/check.py` and the MappingConfig the
harness gave them before."""

import ast
import dataclasses
import importlib
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

from conftest import BASE, ROOT, make_tiny
from portbench import harness
from portbench.harness import mapping_config, run_cell
from portbench.spec import NAMED_FOLDERS, Spec
from portbench.traffic import barcoded_reads, paired_reads

SEED = 2 ** 33 + 17
CELL = "probe_chip.bc64"

PROBE = '''"""Records its arguments beside the output, and counts the output's
fragments whose cell barcode is not in the whitelist."""

import json
import os


def check(conf, fasta, index_dir, lanes, out_path, seed):
    with open(lanes[0]["whitelist"], "rb") as f:
        whitelist = set(f.read().split())
    lines = []
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            lines = [line.split(b"\\t") for line in f]
    off = sum(len(c) != 5 or c[3] not in whitelist for c in lines)
    pairs = sum(lane["pairs"] for lane in lanes)
    checks = {"off_whitelist": off,
              "compared_under_half": int(2 * len(lines) < pairs),
              "output_absent": int(not os.path.exists(out_path))}
    with open(os.path.join(os.path.dirname(out_path), "probe.json"),
              "w") as f:
        json.dump({"config": conf["name"], "fasta": fasta,
                   "index_dir": index_dir, "lanes": lanes,
                   "out_path": out_path, "seed": seed, "lines": len(lines),
                   "checks": checks}, f)
    return checks, {"lines": len(lines)}
'''

# a check that loads a stub of the JAX package as it judges
PROBE_JAX = '''import os
import sys
import types


def check(conf, fasta, index_dir, lanes, out_path, seed):
    sys.modules["chromap_tpu"] = types.ModuleType("chromap_tpu")
    open(os.path.join(os.path.dirname(out_path), "probe_jax.ran"),
         "w").close()
    return {"compared_under_half": 0, "output_absent": 0}, {}
'''

MIX = {"generator": "barcoded_reads", "read_length": 100,
       "fragment_min": 150, "fragment_max": 499, "mismatches_max": 2,
       "indel_share": 0.02, "pcr_dup_share": 0.1, "barcode_length": 16,
       "whitelist_size": 64, "cells": 64, "barcode_error_share": 0.1,
       "lanes": [{"pairs": 250000}, {"pairs": 250000}]}


@pytest.fixture(scope="module")
def probe_root(tmp_path_factory):
    """A full-size copy of the benchmark with the probe's files and
    entries added, shrunk by make_tiny."""
    src = str(tmp_path_factory.mktemp("probe_src"))
    for sub in NAMED_FOLDERS:
        if os.path.isdir(os.path.join(BASE, sub)):
            shutil.copytree(os.path.join(BASE, sub),
                            os.path.join(src, "portbench", sub),
                            ignore=shutil.ignore_patterns("__pycache__"))
    base = os.path.join(src, "portbench")
    with open(os.path.join(base, "configs", "chip_dm6.json")) as f:
        conf = json.load(f)
    with open(os.path.join(base, "traffic", "bc64.json"), "w") as f:
        json.dump(MIX, f)
    os.makedirs(os.path.join(base, "checks"), exist_ok=True)
    for name, text in (("probe", PROBE), ("probe_jax", PROBE_JAX)):
        with open(os.path.join(base, "checks", name + ".py"), "w") as f:
            f.write(text)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    # probe_absent names a check that has no file
    for name, check in (("probe_chip", "probe"), ("probe_jax", "probe_jax"),
                        ("probe_absent", "absent")):
        # no `options`: make_tiny has to shrink a configuration of any keys
        with open(os.path.join(base, "configs", name + ".json"), "w") as f:
            json.dump({"preset": "chip", "check": check,
                       "genome": conf["genome"], "control": conf["control"],
                       "reduced": conf["reduced"]}, f)
        b["configs"].append({"name": name, "source": "https://example.org",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": ["genome_core"], "why": "barcoded"})
        b["workloads"].append({"name": name + ".bc64", "config": name,
                               "traffic": "bc64", "chips": 1,
                               "why": "barcodes"})
    with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return make_tiny(str(tmp_path_factory.mktemp("probe_tiny")), src)


def test_make_tiny_shrinks_the_new_files(probe_root):
    spec = Spec(probe_root)
    conf = spec.config("probe_chip")
    assert conf["genome"]["genome_core"] == 300_000
    assert conf["options"] == {"device_batch_size": 256}
    assert [lane["pairs"] for lane in spec.mix("bc64")["lanes"]] == \
        [1536, 1464]
    assert os.path.exists(os.path.join(spec.base, "checks", "probe.py"))


def test_barcoded_pairs_map_and_the_named_check_judges(probe_root, capsys,
                                                        monkeypatch):
    tails = []
    one_pass = harness.one_pass

    def logged_pass(pipeline, out):
        rec = one_pass(pipeline, out)
        tails.append(rec["log_tail"])
        return rec
    monkeypatch.setattr(harness, "one_pass", logged_pass)
    # one warm pass: the hybrid's settling is not what this test is about
    monkeypatch.setattr(harness, "MAX_WARM_PASSES", 1)
    result = run_cell(Spec(probe_root), CELL, SEED, 0.5, False,
                      device="cpu")
    assert result["correct"], result["checks"]
    assert "Loaded 64 barcodes." in capsys.readouterr().err
    corrected = re.findall(r"Number of corrected barcodes: (\d+)\.",
                           tails[-1])
    assert corrected and int(corrected[-1]) > 0
    with open(os.path.join(Spec(probe_root).base, "_data", "runs", CELL,
                           "probe.json")) as f:
        got = json.load(f)
    assert got["config"] == "probe_chip" and got["seed"] == SEED
    assert got["out_path"].endswith(os.sep + "out.bed")
    assert [lane["bc"].rsplit(os.sep, 1)[1] for lane in got["lanes"]] == \
        ["lane0_bc.fq", "lane1_bc.fq"]
    assert len({lane["whitelist"] for lane in got["lanes"]}) == 1
    assert got["lines"] > 0
    assert result["checks"] == {k: {"value": 0, "limit": 0}
                                for k in got["checks"]}
    assert "off_whitelist" in result["checks"]
    assert list(result)[-1] == "checks"


def test_a_check_is_resolved_before_the_mapping(probe_root, monkeypatch):
    def mapped(*args):
        raise AssertionError("the mapping started")
    monkeypatch.setattr(harness, "ensure_genome", mapped)
    with pytest.raises(FileNotFoundError, match="absent"):
        run_cell(Spec(probe_root), "probe_absent.bc64", SEED, 0.5, False,
                 device="cpu")


def test_what_the_check_loads_counts_in_the_scan(probe_root, monkeypatch):
    assert "chromap_tpu" not in sys.modules
    monkeypatch.setattr(harness, "MAX_WARM_PASSES", 1)
    try:
        with pytest.raises(ImportError, match="chromap_tpu"):
            run_cell(Spec(probe_root), "probe_jax.bc64", SEED, 0.5, False,
                     device="cpu")
    finally:
        sys.modules.pop("chromap_tpu", None)
    assert os.path.exists(os.path.join(Spec(probe_root).base, "_data",
                                       "runs", "probe_jax.bc64",
                                       "probe_jax.ran"))


def _lanes(**extra):
    return [{"r1": f"L/lane{i}_1.fq", "r2": f"L/lane{i}_2.fq", "pairs": 1,
             **{k: v[i] for k, v in extra.items() if v[i] is not None}}
            for i in range(2)]


@pytest.mark.parametrize("lanes,match", [
    (_lanes(bc=["L/b0.fq", None]), "lane 1"),
    (_lanes(bc=[None, "L/b1.fq"]), "lane 1"),
    (_lanes(bc=["L/b0.fq", "L/b1.fq"], whitelist=["W0", "W1"]), "lane 1"),
    (_lanes(bc=["L/b0.fq", "L/b1.fq"], whitelist=["W", None]), "lane 1"),
    (_lanes(whitelist=["W", "W"]), "no barcode read"),
])
def test_lanes_that_disagree_raise(lanes, match):
    with pytest.raises(ValueError, match=match):
        mapping_config({"preset": "chip"}, "G", lanes, "R", "cpu")


def test_barcoded_lanes_set_the_single_cell_inputs():
    cfg = mapping_config(
        {"preset": "chip"}, "G",
        _lanes(bc=["L/b0.fq", "L/b1.fq"], whitelist=["W", "W"]), "R", "cpu")
    assert cfg.barcode_file_paths == ["L/b0.fq", "L/b1.fq"]
    assert cfg.is_bulk_data is False
    assert cfg.barcode_whitelist_file_path == "W"


# the fields the harness sets for each real configuration, as it set them
# before configurations could bring barcodes and checks
FROZEN = {
    "bed_dm6": {"low_memory_mode": False, "num_threads": 4,
                "output_format": "bed"},
    "hic_dm6": {"num_threads": 4, "output_format": "pairs"},
    "chip_dm6": {"num_threads": 4, "output_format": "bed"},
}
HARNESS_SET = {"reference_file_path": "G/ref.fa",
               "index_file_path": "G/index",
               "read_file1_paths": ["L/lane0_1.fq"],
               "read_file2_paths": ["L/lane0_2.fq"],
               "use_device": True, "torch_device": "cuda",
               "barcode_file_paths": [], "is_bulk_data": True,
               "barcode_whitelist_file_path": ""}
OUT = {"bed_dm6": "R/out.bed", "hic_dm6": "R/out.pairs",
       "chip_dm6": "R/out.bed"}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_real_configurations_are_unchanged(name, tmp_path):
    from chromap_tpu_torch.config import MappingConfig, apply_preset
    spec = Spec()
    conf = spec.config(name)
    assert spec.checker(conf) is importlib.import_module(
        "portbench.reference.check")
    assert set(conf["options"].items()) <= set(FROZEN[name].items())
    # the real mixes' lanes carry the mates and nothing else
    genome = str(tmp_path / "g.fa")
    paired_reads.write_genome(genome, 20_000, 1)
    for w in spec.data["workloads"]:
        if w["config"] == name:
            mix = {**spec.mix(w["traffic"]), "lanes": [{"pairs": 10}]}
            lanes = spec.generator(mix).write_lanes(
                str(tmp_path / w["name"]), genome, mix, 5)
            assert [set(lane) for lane in lanes] == [{"r1", "r2", "pairs"}]
    lanes = [{"r1": "L/lane0_1.fq", "r2": "L/lane0_2.fq", "pairs": 1}]
    cfg = mapping_config(conf, "G", lanes, "R", "cuda")
    want = MappingConfig()
    apply_preset(want, conf["preset"])
    for key, value in {**HARNESS_SET, **FROZEN[name],
                       "mapping_output_file_path": OUT[name]}.items():
        setattr(want, key, value)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_harness_imports_no_output_check():
    path = os.path.join(BASE, "harness.py")
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert "reference" not in (node.module or "").split(".")
            assert "check" not in {a.name for a in node.names}


@pytest.mark.parametrize("key", barcoded_reads.KEYS)
def test_the_mix_states_every_barcode_key(key, tmp_path):
    mix = {k: v for k, v in MIX.items() if k != key}
    with pytest.raises(KeyError, match=key):
        barcoded_reads.write_lanes(str(tmp_path), "absent.fa", mix, 9)


def test_barcode_generator(tmp_path):
    genome = str(tmp_path / "g.fa")
    paired_reads.write_genome(genome, 20_000, 1)
    mix = {**MIX, "lanes": [{"pairs": 700}, {"pairs": 300}]}
    lanes = barcoded_reads.write_lanes(str(tmp_path / "a"), genome, mix, 9)
    with open(lanes[0]["whitelist"], "rb") as f:
        whitelist = f.read().split()
    assert len(whitelist) == len(set(whitelist)) == 64
    assert {len(b) for b in whitelist} == {16}
    bcs = []
    for lane in lanes:
        with open(lane["bc"], "rb") as f:
            bcs += f.read().split(b"\n")[1::4]
    assert len(bcs) == 1000
    d = os.path.dirname(lanes[0]["r1"])
    entry = np.load(os.path.join(d, "barcodes.npy"))
    roots = np.load(os.path.join(d, "roots.npy"))
    assert np.array_equal(entry, entry[roots])
    true = np.frombuffer(b"".join(whitelist), np.uint8).reshape(64, 16)[entry]
    seen = np.frombuffer(b"".join(bcs), np.uint8).reshape(1000, 16)
    assert np.bincount((true != seen).sum(axis=1)).tolist() == [900, 100]
    # the reads are paired_reads' for the seed; the same seed, the same
    # bytes, and the whitelist the mix's own for every seed
    plain = paired_reads.write_lanes(str(tmp_path / "p"), genome, mix, 9)
    again = barcoded_reads.write_lanes(str(tmp_path / "b"), genome, mix, 9)
    other = barcoded_reads.write_lanes(str(tmp_path / "c"), genome, mix, 10)
    for key in ("r1", "r2"):
        assert open(plain[0][key], "rb").read() == \
            open(lanes[0][key], "rb").read()
    assert open(again[1]["bc"], "rb").read() == \
        open(lanes[1]["bc"], "rb").read() != open(other[1]["bc"], "rb").read()
    assert open(other[0]["whitelist"], "rb").read() == \
        open(lanes[0]["whitelist"], "rb").read()
    few = barcoded_reads.write_lanes(str(tmp_path / "d"), genome,
                                     {**mix, "cells": 8}, 9)
    entry = np.load(os.path.join(os.path.dirname(few[0]["r1"]),
                                 "barcodes.npy"))
    assert len(np.unique(entry)) == 8
