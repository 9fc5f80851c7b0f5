"""The paired records flow reading its FASTQ natively
(pipeline.py `_native_pair_stream`, native NativeFastxPairStream) against
the same flow on the Python reader, through the port's CLI with
`--device --torch-device cpu`. `--preset hic` (.pairs, read names
included, the record spill) and `--preset chip` (low-memory BED, the
array spill and the native merge) write the same bytes either way: in
one read batch, in batches that force several spill files, and over
inputs split into a plain and a gzip file with a batch across the cut.
Each native read is counted once (records.native_batches equals the
records.read spans). Runs whose batches need the Python records,
`--read-format` slices and barcodes, keep the Python reader, count no
native read and still equal their goldens."""

import contextlib
import gzip
import io
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from simulate import (write_simulated_barcodes,  # noqa: E402
                      write_simulated_dataset)

from chromap_tpu_torch import cli, pipeline, tracing  # noqa: E402

DEVICE_ARGS = ["--device", "--torch-device", "cpu",
               "--device-batch-size", "256", "-t", "2"]
SEEDED = "Using CPU (plain torch) device seeding"
# a spill whenever more than 500 rows wait
SMALL_BUDGET = {"CHROMAP_TPU_LOWMEM_MAX_RECORDS": "500"}
SPLIT_AT = 1700  # the pairs in the first of the two files
CASES = {
    # name: (flags, the inputs' form, environment, golden)
    "hic": (["--preset", "hic"], "one", None, "sim_hic.pairs"),
    "hic_spills": (["--preset", "hic", "--read-batch-size", "1200"],
                   "one", SMALL_BUDGET, None),
    "hic_two_files": (["--preset", "hic", "--read-batch-size", "1200"],
                      "two", None, None),
    "chip": (["--preset", "chip"], "one", None, "sim_chip.bed"),
    "chip_spills": (["--preset", "chip", "--read-batch-size", "600"],
                    "one", SMALL_BUDGET, None),
    "chip_two_files": (["--preset", "chip", "--read-batch-size", "1200"],
                       "two", None, None),
}
PYTHON_CASES = {
    "read_format": (["-b", "{d}/bc.fq", "--read-format",
                     "r1:5:84,r2:0:79,bc:0:7"], "sim_readformat.bed"),
    "barcodes": (["--preset", "hic", "-b", "{d}/bc.fq",
                  "--barcode-whitelist", "{d}/whitelist.txt"],
                 "sim_bc.pairs"),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchnativerecords")
    write_simulated_dataset(str(d))
    write_simulated_barcodes(str(d))
    for end in (1, 2):
        lines = (d / f"r{end}.fq").read_bytes().splitlines(keepends=True)
        (d / f"r{end}a.fq").write_bytes(b"".join(lines[:4 * SPLIT_AT]))
        (d / f"r{end}b.fq.gz").write_bytes(
            gzip.compress(b"".join(lines[4 * SPLIT_AT:])))
    assert cli.parse_args_and_run(["-i", "-r", str(d / "ref.fa"),
                                   "-o", str(d / "index")]) == 0
    return d


def _map(d, name, flags, inputs="one", env=None, python_reader=False):
    """One in-process CLI run with the tracer on: its output's bytes and
    its pass's counters and span counts."""
    out = d / name
    reads = {"one": ["-1", f"{d}/r1.fq", "-2", f"{d}/r2.fq"],
             "two": ["-1", f"{d}/r1a.fq,{d}/r1b.fq.gz",
                     "-2", f"{d}/r2a.fq,{d}/r2b.fq.gz"]}[inputs]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(tracing.SWITCH, "1")
            for key, value in (env or {}).items():
                mp.setenv(key, value)
            if python_reader:
                mp.setattr(pipeline.MappingPipeline, "_native_pair_stream",
                           lambda self, engine: None)
            log = io.StringIO()
            with contextlib.redirect_stderr(log):
                rc = cli.parse_args_and_run(
                    ["-x", str(d / "index"), "-r", str(d / "ref.fa")]
                    + reads + ["-o", str(out)]
                    + [a.format(d=d) for a in flags] + DEVICE_ARGS)
    finally:
        torch.set_num_threads(threads)
    assert rc == 0, log.getvalue()
    assert SEEDED in log.getvalue(), log.getvalue()
    last = tracing.last_pass()
    return {"out": out.read_bytes(), "counters": last["counters"],
            "reads": last["spans"]["records.read"][0]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_read_equals_python_read(data, golden_dir, case):
    flags, inputs, env, golden = CASES[case]
    native = _map(data, f"{case}.native.out", flags, inputs, env)
    python = _map(data, f"{case}.python.out", flags, inputs, env,
                  python_reader=True)
    assert native["out"] == python["out"]
    assert native["out"].count(b"\n") > 1000
    if golden:
        assert native["out"] == (golden_dir / golden).read_bytes()
    # the last read finds no pairs
    batches = -(-5000 // int(flags[-1])) if "--read-batch-size" in flags \
        else 1
    assert native["reads"] == python["reads"] == batches + 1
    assert native["counters"]["records.native_batches"] == native["reads"]
    assert "records.native_batches" not in python["counters"]
    if env:
        assert native["counters"]["lowmem.spills"] == \
            python["counters"]["lowmem.spills"] > 1


@pytest.mark.parametrize("case", sorted(PYTHON_CASES))
def test_records_needed_keep_the_python_reader(data, golden_dir, case):
    flags, golden = PYTHON_CASES[case]
    run = _map(data, f"{case}.{golden}", flags)
    assert "records.native_batches" not in run["counters"]
    assert run["reads"] == 2
    assert run["out"] == (golden_dir / golden).read_bytes()
