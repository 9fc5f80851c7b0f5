"""Each per-layer reader computes its number from a recorded run (pass
logs, counters and a reduced trace, record_bed.json), and reads nothing
where there is nothing; the trace reduction on a made-up timeline."""

import glob
import importlib
import json
import os

import pytest

from portbench.spec import Spec
from portbench.trace import kernel_name, kernel_seconds, reduce_trace

from conftest import HERE

with open(os.path.join(HERE, "record_bed.json")) as f:
    RECORD = json.load(f)

WANT = {
    "pipeline.output_share": 0.25,
    "pipeline.records_share": (2 * 1.5 - 2 * 1.2) / 4.0,
    "hybrid.device_chunk_share": 38 / 62,
    "hybrid.blocked_share": 0.1,
    "native.map_ms_per_kpair": 1.8e6 / 360000,
    "native.finish_ms_per_chunk": 30.0,
    "seeder.submit_ms_per_chunk": 10.0,
    "seeder.fallback_row_share": 655 / 655360,
    "library.device_ms_per_chunk": 0.2 * 1e3 / 40,
    "dense_minimizer_roofline": 100 * 2.0e9 / 3.35e12 / 0.004,
    "cluster_scan_roofline": 100 * 4.0e9 / 3.35e12 / 0.002,
    "myers_roofline": 100 * 2.2e9 / 3.35e12 / 0.0016,
    "device.idle_share": 0.875,
    "program.reads_per_s": 20000000 / 40.0,
    "program.core_s_per_mread": 100.0 / 20.0,
}
# the BED cell's copies of metrics the Hi-C cell reads too
WANT.update({name + ".bed": WANT[name] for name in (
    "pipeline.output_share", "hybrid.device_chunk_share",
    "seeder.fallback_row_share", "library.device_ms_per_chunk",
    "dense_minimizer_roofline", "cluster_scan_roofline",
    "device.idle_share")})


def test_every_metric_has_a_case():
    """Every per-layer metric has a case in the `WANT` of some test file
    here (myers_dropoff_roofline in its own test below), and every case is
    a metric: a later PR's metric cases can live in a file of their own."""
    cases = set()
    for path in glob.glob(os.path.join(HERE, "test_*.py")):
        module = importlib.import_module(os.path.basename(path)[:-3])
        cases |= set(getattr(module, "WANT", {}))
    assert cases | {"myers_dropoff_roofline"} == {
        m["name"] for m in Spec().data["per_layer"]}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_the_record(name):
    assert Spec().reader(name).read(RECORD) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT) + ["myers_dropoff_roofline"])
def test_reader_finds_nothing_in_an_empty_run(name):
    empty = {"passes": [], "trace": {}, "kernel_bytes": {}}
    assert Spec().reader(name).read(empty) is None


def test_dropoff_roofline_needs_its_launches():
    rec = json.loads(json.dumps(RECORD))
    read = Spec().reader("myers_dropoff_roofline").read
    assert read(rec) is None
    rec["trace"]["ops"]["myers_dropoff_kernel(int const*)"] = [0.001, 2]
    rec["kernel_bytes"]["myers_dropoff"] = [1.675e9, 2]
    assert read(rec) == pytest.approx(50.0)
    rec["kernel_bytes"]["myers_dropoff"] = [1.675e9, 3]
    assert read(rec) is None


def test_kernel_names():
    assert kernel_name("myers_kernel") == "myers"
    assert kernel_name("void myers_dropoff_kernel(int const*)") == \
        "myers_dropoff"
    assert kernel_name("myers_dropoff_kernel") == "myers_dropoff"
    assert kernel_name("(anonymous namespace)::cluster_scan_kernel(unsigned "
                       "long const*, int const*)") == "cluster_scan"
    assert kernel_name("void at::native::elementwise_kernel<128>") == ""


def test_reduce_trace_on_a_timeline():
    ms = 1_000_000
    ev = [("portbench.pass", False, 0, 100 * ms),
          ("portbench.pass", False, 101 * ms, 200 * ms),
          ("portbench.hybrid", False, 10 * ms, 60 * ms),
          ("portbench.output", False, 150 * ms, 195 * ms),
          ("portbench.pass", True, 0, 100 * ms),
          ("myers_kernel", True, 20 * ms, 30 * ms),
          ("void sort_kernel<int>(int)", True, 25 * ms, 40 * ms),
          ("Memcpy DtoH (Device -> Pinned)", True, 40 * ms, 41 * ms),
          ("myers_kernel", True, 198 * ms, 205 * ms)]
    t = reduce_trace(ev)
    assert t["window_s"] == pytest.approx(0.2)
    assert t["busy_s"] == pytest.approx(0.021 + 0.002)
    assert t["ops"]["myers_kernel"] == pytest.approx([0.017, 2])
    assert t["device_ops"][0][0] == "myers_kernel"
    labels = [g[0] for g in t["idle_gaps"]]
    assert t["idle_gaps"][0] == ["mapping", pytest.approx(0.157)]
    assert labels[1] == "hybrid" and t["idle_gaps"][1][1] == \
        pytest.approx(0.020)
    assert reduce_trace([("myers_kernel", True, 0, 1)]) == {}
    # kernels only, overlaps once: the copy and the pass's image go out
    assert kernel_seconds(ev) == pytest.approx(0.020 + 0.007)
    assert kernel_seconds([]) == 0
