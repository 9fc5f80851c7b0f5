"""The port's tracer (chromap_tpu_torch/tracing.py) through the CLI with
`--device --torch-device cpu --device-batch-size 512`. With
CHROMAP_TPU_HYBRID_PROFILE set, a full-native BED run, a `--preset hic`
run and a `--preset chip` run (the records flow, with low-memory spill
and merge), and two single-end runs (full-native BED and the records
flow's SAM) each print one HYBRID_PROFILE line a pass, with the spans
and counters the flow takes, the device-chunk scheduler's groups in
every one; the spans nest and their self times add up;
the output stage's C++ stamps nest inside output.native; the records
flows read their FASTQ natively, one records.native_batches a
records.read, and Hi-C stashes its .pairs rows as arrays, one
records.pairs_array_batches a batch; the outputs equal the untraced run's. Unset, nothing is printed or kept. The clock
anchor is held against a CPU-only torch.profiler."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from simulate import write_simulated_dataset  # noqa: E402

from chromap_tpu_torch import tracing  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DEVICE_ARGS = ["--device", "--torch-device", "cpu",
               "--device-batch-size", "512"]
ENV = dict(os.environ, OMP_NUM_THREADS="2")
ENV.pop(tracing.SWITCH, None)
# runs the CLI, then writes tracing.last_pass() to the file argv[1]
RUN = ("import json, sys; from chromap_tpu_torch import cli, tracing; "
       "rc = cli.parse_args_and_run(sys.argv[2:]); "
       "json.dump(tracing.last_pass(), open(sys.argv[1], 'w')); "
       "sys.exit(rc)")

DEVICE_SPANS = {"pass", "hybrid.flush", "seeder.pack", "seeder.submit",
                "hybrid.wait", "native.finish", "native.cpu_map"}
COUNTERS = {"chunks.dev", "chunks.cpu", "pairs.cpu", "hybrid.flushes",
            "hybrid.group_sum"}
# the Python records flow with low-memory spill and merge; the native
# merge counts no per-record merge
RECORDS_SPANS = DEVICE_SPANS | {"records.read", "records.pack", "hybrid",
                                "records.emit", "lowmem.spill",
                                "lowmem.merge"}
# the records flows' FASTQ read natively (records.native_batches)
LOWMEM_COUNTERS = COUNTERS | {"lowmem.spills", "lowmem.spill_rows",
                              "lowmem.merge_rows_out",
                              "records.native_batches"}
# full-native BED: native FASTQ reader, the scheduler's slot copies, the
# native output stage
FULL_NATIVE_SPANS = DEVICE_SPANS | {"fastq.wait", "hybrid.copy",
                                    "output.concat", "output.native",
                                    "output.sort", "output.write"}
# (options, output, spans, counters, paired)
FLOWS = {
    "bed": ([], "out.bed", FULL_NATIVE_SPANS, COUNTERS, True),
    # Hi-C: .pairs rows stashed as arrays (records.pairs_array_batches),
    # the array spill and the native merge
    "hic": (["--preset", "hic"], "out.pairs", RECORDS_SPANS,
            LOWMEM_COUNTERS | {"records.pairs_array_batches"}, True),
    # --preset chip: BED rows stashed as arrays, the array spill and the
    # native merge with its PCR dedup
    "chip": (["--preset", "chip"], "out.bed", RECORDS_SPANS,
             LOWMEM_COUNTERS, True),
    # single-end, -1 alone: the full-native BED flow, and the records
    # flow's SAM through the Python output stage
    "se_bed": ([], "out.bed", FULL_NATIVE_SPANS, COUNTERS, False),
    "se_sam": (["--SAM"], "out.sam", DEVICE_SPANS | {
        "records.read", "records.pack", "hybrid", "records.emit",
        "output.sort", "output.write"}, COUNTERS, False),
}


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simtorchtrace")
    write_simulated_dataset(str(d))
    subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
                    "-r", f"{d}/ref.fa", "-o", f"{d}/index"],
                   check=True, capture_output=True, cwd=ROOT, env=ENV)
    return d


def _run(d, flow, traced):
    extra, out_name, _, _, paired = FLOWS[flow]
    tag = "on" if traced else "off"
    out = d / f"{flow}.{tag}.{out_name}"
    dump = d / f"{flow}.{tag}.json"
    env = dict(ENV, **({tracing.SWITCH: "1"} if traced else {}))
    reads = ["-1", f"{d}/r1.fq"] + (["-2", f"{d}/r2.fq"] if paired else [])
    res = subprocess.run(
        [sys.executable, "-c", RUN, str(dump), "-x", f"{d}/index",
         "-r", f"{d}/ref.fa"] + reads + ["-o", str(out)] + DEVICE_ARGS
        + extra,
        capture_output=True, text=True, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    assert "Using CPU (plain torch) device seeding" in res.stderr
    lines = [json.loads(line.split(" ", 1)[1])
             for line in res.stderr.splitlines()
             if line.startswith("HYBRID_PROFILE ")]
    with open(dump) as f:
        last = json.load(f)
    return {"out": out.read_bytes(), "lines": lines, "last": last}


@pytest.fixture(scope="module")
def runs(sim_data):
    return {(flow, traced): _run(sim_data, flow, traced)
            for flow in FLOWS for traced in (True, False)}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_one_profile_line_a_pass_with_the_flows_spans(runs, flow):
    lines = runs[flow, True]["lines"]
    assert len(lines) == 1
    line = lines[0]
    assert set(line["spans"]) == FLOWS[flow][2]
    assert set(line["counters"]) == FLOWS[flow][3]
    assert line["pass_s"] == line["spans"]["pass"][1]
    assert line["counters"]["chunks.dev"] > 0
    assert line["counters"]["chunks.cpu"] > 0
    # the host chunks hold some of the 5000 pairs (reads), the device
    # chunks the rest
    assert 0 < line["counters"]["pairs.cpu"] < 5000
    assert line["counters"]["hybrid.flushes"] > 0
    # the keys read before the spans existed, from the spans that time
    # the same code
    for key, name in tracing.LEGACY_SPANS.items():
        assert line[key] == line["spans"][name][1]
    assert line["dev_chunks"] == line["counters"]["chunks.dev"]
    last = runs[flow, True]["last"]
    assert last["spans"] == line["spans"]
    assert last["counters"] == line["counters"]


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_spans_nest_and_self_times_add_up(runs, flow):
    last = runs[flow, True]["last"]
    spans = [dict(zip(tracing.INTERVAL_FIELDS, iv))
             for iv in last["intervals"]]
    by_id = {s["id"]: s for s in spans}
    child_ns = {s["id"]: 0 for s in spans}
    for s in spans:
        assert s["end_ns"] >= s["start_ns"] and s["self_ns"] >= 0
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["thread"] == s["thread"]
            assert parent["start_ns"] <= s["start_ns"]
            assert s["end_ns"] <= parent["end_ns"]
            child_ns[parent["id"]] += s["end_ns"] - s["start_ns"]
    for s in spans:
        assert s["self_ns"] + child_ns[s["id"]] == s["end_ns"] - s["start_ns"]
    # one root, and every span on its thread
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "pass"
    assert all(s["thread"] == root["thread"] for s in spans)
    # the totals the line prints are the intervals' sums
    totals = {}
    for s in spans:
        acc = totals.setdefault(s["name"], [0, 0, 0])
        acc[0] += 1
        acc[1] += s["end_ns"] - s["start_ns"]
        acc[2] += s["self_ns"]
    for name, (n, total, own) in totals.items():
        assert last["spans"][name] == pytest.approx([n, total * 1e-9,
                                                     own * 1e-9])
    # a device chunk's spans share its index: each submitted chunk is
    # packed, waited for and finished once
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s["chunk"])
    submitted = sorted(by_name["seeder.submit"])
    assert len(set(submitted)) == len(submitted)
    for name in ("seeder.pack", "hybrid.wait", "native.finish"):
        assert sorted(by_name[name]) == submitted, name
    assert not set(submitted) & set(by_name["native.cpu_map"])


@pytest.mark.parametrize("flow", ["chip", "hic"])
def test_native_reads_count_one_a_records_read(runs, flow):
    line = runs[flow, True]["lines"][0]
    reads = line["spans"]["records.read"][0]
    # the 5000 pairs in one batch, then the read that finds none
    assert reads == 2
    assert line["counters"]["records.native_batches"] == reads
    if flow == "hic":
        # one array stash a batch that held reads
        assert line["counters"]["records.pairs_array_batches"] == reads - 1


def test_output_stamps_nest_inside_output_native(runs):
    last = runs["bed", True]["last"]
    spans = [dict(zip(tracing.INTERVAL_FIELDS, iv))
             for iv in last["intervals"]]
    (native,) = [s for s in spans if s["name"] == "output.native"]
    stages = [s for s in spans
              if s["name"] in ("output.sort", "output.write")]
    assert sorted(s["name"] for s in stages) == [
        "output.sort", "output.write"]
    for s in stages:
        assert s["parent"] == native["id"]
        assert native["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= native["end_ns"]
    # in order: sort, then write, the one after the other
    stages.sort(key=lambda s: s["start_ns"])
    assert [s["name"] for s in stages] == ["output.sort", "output.write"]
    assert all(a["end_ns"] == b["start_ns"]
               for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_outputs_equal_the_untraced_run(runs, flow):
    assert runs[flow, True]["out"] == runs[flow, False]["out"]


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_switch_off_prints_and_keeps_nothing(runs, flow):
    assert runs[flow, False]["lines"] == []
    assert runs[flow, False]["last"] is None


def test_span_off_is_one_shared_object():
    assert not tracing.TRACER.on
    assert tracing.span("a") is tracing.span("b", 3)
    tracing.count("a")
    tracing.add("a", 0, 1)
    assert tracing.chunk_ids(4) == 0


def test_anchor_puts_spans_on_the_profilers_clock(monkeypatch, capsys):
    """A span shifted by its pass's chromap.clock anchor starts where a
    record_function opened at the same moment starts on the profiler's
    clock, to within 1 ms: in the median of seven passes, so that the
    thread's being descheduled between two readings on a loaded host
    does not decide it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    monkeypatch.setenv(tracing.SWITCH, "1")

    @tracing.traced_pass
    def one_pass():
        time.sleep(0.05)
        with record_function("probe"), tracing.span("probe"):
            time.sleep(0.01)

    passes = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(7):
            one_pass()
            passes.append(tracing.last_pass())
    assert capsys.readouterr().err.count("HYBRID_PROFILE ") == 7
    starts = {}
    for ev in prof.profiler.kineto_results.events():
        start = (ev.start_ns() if hasattr(ev, "start_ns")
                 else ev.start_us() * 1000)
        starts.setdefault(ev.name(), []).append(start)
    clocks, probes = sorted(starts["chromap.clock"]), sorted(starts["probe"])
    assert len(clocks) == len(probes) == 7
    errors = []
    for last, clock, probe_start in zip(passes, clocks, probes):
        shift = clock - last["anchor_ns"]
        (probe,) = [iv for iv in last["intervals"] if iv[0] == "probe"]
        errors.append(abs(probe[2] + shift - probe_start))
    assert sorted(errors)[3] < 1_000_000, errors
