"""BENCHMARK.json, and every file it names, found by name; new
configurations, mixes and metrics added as files only."""

import json
import os
import re
import shutil

import pytest

from portbench.spec import Spec

from conftest import BASE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_file_keeps_its_shape():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    ends = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in ends
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in ends
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_entry_resolves_to_its_files():
    spec = Spec()
    for c in spec.data["configs"]:
        conf = spec.config(c["name"])
        assert set(c["reduced"]) == set(conf["reduced"])
        assert {"genome", "options", "control"} <= set(conf)
        assert callable(spec.checker(conf).check)
    for w in spec.data["workloads"]:
        mix = spec.mix(w["traffic"])
        assert hasattr(spec.generator(mix), "write_lanes")
        metrics = spec.metrics(w["name"], True)
        assert metrics, w["name"]
        ends = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        for m in metrics:
            assert m["moves"] in ends, (w["name"], m["name"])
    for m in spec.data["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        for cell in m.get("workloads", []):
            spec.cell(cell)


def test_files_of_the_folder_all_parse():
    for sub in ("configs", "traffic"):
        for name in os.listdir(os.path.join(BASE, sub)):
            if name.endswith(".json"):
                with open(os.path.join(BASE, sub, name)) as f:
                    json.load(f)
    spec = Spec()
    for name in os.listdir(os.path.join(BASE, "metrics")):
        if name.endswith(".py"):
            assert callable(spec.reader(name[:-3]).read)


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(BASE, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("_data", "__pycache__"))
    before = {p: open(p, "rb").read()
              for p in _files(os.path.join(root, "portbench"))}
    b = bench()
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "configs", "bed_sc3.json"), "w") as f:
        json.dump({"preset": "chip", "options": {},
                   "genome": {"genome_core": 8_000_000, "seed": 3,
                              "kmer_size": 17, "window_size": 7},
                   "control": {"remove_pcr_duplicates": False},
                   "reduced": {}}, f)
    with open(os.path.join(base, "traffic", "pe50.json"), "w") as f:
        json.dump({"generator": "paired_reads", "read_length": 50,
                   "lanes": [{"pairs": 1000}]}, f)
    with open(os.path.join(base, "metrics", "passes.count.py"), "w") as f:
        f.write("def read(record):\n    return len(record['passes'])\n")
    b["configs"].append({"name": "bed_sc3", "source": "https://example.org",
                         "file": "portbench/configs/bed_sc3.json",
                         "reduced": [], "why": "small genome"})
    b["workloads"].append({"name": "bed_sc3.pe50", "config": "bed_sc3",
                           "traffic": "pe50", "chips": 1, "why": "control"})
    for m in b["end_to_end"]:
        if m["name"] == "reads_per_s":
            m["workloads"].append("bed_sc3.pe50")
    b["per_layer"].append({"name": "passes.count", "unit": "passes",
                           "better": "higher", "source": "host_clock",
                           "layer": "pipeline: postprocess and write",
                           "moves": "reads_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    spec = Spec(root)
    assert spec.config("bed_sc3")["genome"]["genome_core"] == 8_000_000
    assert spec.mix("pe50")["read_length"] == 50
    names = {m["name"] for m in spec.metrics("bed_sc3.pe50", True)}
    assert "passes.count" in names
    assert "passes.count" in {m["name"] for m in
                              spec.metrics("hic_dm6.junction25", True)}
    assert "passes.count" not in {m["name"] for m in
                                  spec.metrics("bed_dm6.pe100", True)}
    assert spec.reader("passes.count").read({"passes": [1, 2]}) == 2
    gen = spec.generator(spec.mix("pe50"))
    lanes = gen.write_lanes(os.path.join(root, "reads"),
                            _genome(root), spec.mix("pe50"), 5)
    with open(lanes[0]["r1"], "rb") as f:
        assert len(f.read().split(b"\n")[1]) == 50
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _files(top):
    return [os.path.join(d, n) for d, _, ns in os.walk(top) for n in ns]


def _genome(root):
    from portbench.traffic.paired_reads import write_genome
    path = os.path.join(root, "g.fa")
    write_genome(path, 20_000, 1)
    return path


@pytest.mark.parametrize("trace", [False, True])
def test_cells_report_their_metrics(trace):
    spec = Spec()
    for w in spec.data["workloads"]:
        got = {m["name"] for m in spec.metrics(w["name"], trace)}
        want = {m["name"] for m in spec.data["per_layer" if trace
                                             else "end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert got == want
