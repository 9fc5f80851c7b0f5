"""The port's host path against the reference goldens: the cases of
tests/test_parity.py, tests/test_sim_parity.py and
tests/test_feature_parity.py driven through `python -m
chromap_tpu_torch.cli`, with the case tables imported from those files.

- The ten goldens that the reference chromap wrote on the bundled reads
  of tests/data/ (the only real reference-chromap reads in the repo),
  and the -e 20 run of the native engine against the per-read engine.
  Their BED and pairs goldens also go through `--device --torch-device
  cpu` with a device batch of two pairs, so that the 10-pair set spans
  several hybrid chunks and reaches the seeder (L = 100).
- The simulated set's single-end, Tn5 and PAF goldens, and the per-read
  engine wherever the JAX suite runs it.
- The feature surface: pairs flipping, barcode translation, minus-strand
  read-format barcodes, the atac preset's SAM, barcoded PAF, gzip
  inputs, forced low-memory spills and the feature-barcode matrix.
Every output must equal its golden byte for byte (the summary CSVs as
sets: the reference writes barcodes in hash-table order)."""

import gzip
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from simulate import (write_barcode_translate_table,  # noqa: E402
                      write_simulated_barcodes, write_simulated_dataset,
                      write_simulated_multichrom_dataset)
from test_feature_parity import MC_CASES, SC_CASES, SE_BC_CASES  # noqa
from test_parity import CASES as PARITY_CASES  # noqa: E402
from test_sim_parity import CASES as SIM_CASES  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
ENV = dict(os.environ, OMP_NUM_THREADS="2")
DEVICE_ARGS = ["--device", "--torch-device", "cpu",
               "--device-batch-size", "2"]
SEEDED = "Using CPU (plain torch) device seeding"


def _cli(args, env=ENV):
    res = subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli"]
                         + [str(a) for a in args], capture_output=True,
                         text=True, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    return res


def _index(d):
    _cli(["-i", "-r", f"{d}/ref.fa", "-o", f"{d}/index"])


@pytest.fixture(scope="module")
def data_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchdata")
    _cli(["-i", "-r", DATA / "ref.fa", "-o", d / "index"])
    return d / "index"


@pytest.fixture(scope="module")
def sc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchsc")
    write_simulated_dataset(str(d))
    write_simulated_barcodes(str(d))
    write_barcode_translate_table(str(d))
    _index(d)
    return d


@pytest.fixture(scope="module")
def mc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchmc")
    write_simulated_multichrom_dataset(str(d))
    _index(d)
    return d


# ---------------------------------------------------------------------
# tests/data: the reference chromap's own outputs
# ---------------------------------------------------------------------

def _data_run(data_index, tmp_path, golden, extra, more=()):
    out = tmp_path / golden
    args = ["-x", data_index, "-r", DATA / "ref.fa", "-o", out]
    args += [a.format(r1=DATA / "read1.fq", r2=DATA / "read2.fq")
             for a in extra]
    res = _cli(args + list(more))
    assert out.read_bytes() == (ROOT / "tests/golden" / golden).read_bytes()
    return res


@pytest.mark.parametrize("golden,extra", PARITY_CASES,
                         ids=[c[0] for c in PARITY_CASES])
def test_reference_golden(golden, extra, data_index, tmp_path):
    _data_run(data_index, tmp_path, golden, extra)


DEVICE_CASES = [c for c in PARITY_CASES
                if c[0].endswith((".bed", ".pairs"))]


@pytest.mark.parametrize("golden,extra", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_reference_golden_device(golden, extra, data_index, tmp_path):
    res = _data_run(data_index, tmp_path, golden, extra, DEVICE_ARGS)
    assert SEEDED in res.stderr, res.stderr


def test_wide_band_native_parity(data_index, tmp_path):
    """e = 20 takes the native engine's 64-bit band; it must equal the
    exact per-read engine."""
    outs = {}
    for engine in ("auto", "per_read"):
        out = tmp_path / f"e20_{engine}.bed"
        res = _cli(["--engine", engine, "-e", "20", "-x", data_index,
                    "-r", DATA / "ref.fa", "-1", DATA / "read1.fq",
                    "-2", DATA / "read2.fq", "-o", out])
        if engine == "auto":
            assert "Using native host engine." in res.stderr
        outs[engine] = out.read_bytes()
    assert outs["auto"] == outs["per_read"] and outs["auto"]


# ---------------------------------------------------------------------
# the simulated sets
# ---------------------------------------------------------------------

def _sim_run(d, tmp_path, golden, extra, engine="auto", paired=True,
             env=ENV):
    out = tmp_path / f"{engine}_{golden}"
    args = ["--engine", engine, "-x", f"{d}/index", "-r", f"{d}/ref.fa",
            "-1", f"{d}/r1.fq"]
    if paired:
        args += ["-2", f"{d}/r2.fq"]
    _cli(args + ["-o", out] + [a.format(d=d) for a in extra], env=env)
    assert out.read_bytes() == (ROOT / "tests/golden" / golden).read_bytes()


# the host goldens of test_sim_parity.py that no other port test maps,
# and every case the JAX suite runs through the per-read engine
SIM_RUNS = [(g, x, eng) for g, x, engines in SIM_CASES for eng in engines
            if eng == "per_read" or (
                eng == "auto"
                and g in ("sim_se.bed", "sim_se_tn5.bed", "sim_pe.paf"))]


@pytest.mark.parametrize("golden,extra,engine", SIM_RUNS,
                         ids=[f"{c[0]}-{c[2]}" for c in SIM_RUNS])
def test_sim_golden(golden, extra, engine, sc_data, tmp_path):
    _sim_run(sc_data, tmp_path, golden, [a for a in extra if a != "--se"],
             engine, paired="--se" not in extra)


FEATURE_GOLDENS = ("sim_flip.pairs", "sim_bc_translate.bed",
                   "sim_readformat_minus.bed", "sim_atac.sam", "sim_bc.paf",
                   "sim_se_bc.paf")
FEATURE_RUNS = ([(g, x, "mc_data", True) for g, x, _ in MC_CASES]
                + [(g, x, "sc_data", True) for g, x, _ in SC_CASES]
                + [(g, x, "sc_data", False) for g, x, _ in SE_BC_CASES])
FEATURE_RUNS = [c for c in FEATURE_RUNS if c[0] in FEATURE_GOLDENS]


@pytest.mark.parametrize("golden,extra,data,paired", FEATURE_RUNS,
                         ids=[c[0] for c in FEATURE_RUNS])
def test_feature_golden(golden, extra, data, paired, request, tmp_path):
    d = request.getfixturevalue(data)
    if not paired:
        # test_feature_parity.py's single-end barcoded runs add these
        extra = ["-b", "{d}/bc.fq", "--barcode-whitelist",
                 "{d}/whitelist.txt"] + extra
    _sim_run(d, tmp_path, golden, extra, paired=paired)


def test_gzip_inputs(sc_data, tmp_path):
    """gzip FASTQ through the native reader maps as the plain files."""
    for f in ("r1.fq", "r2.fq"):
        with open(sc_data / f, "rb") as fin, \
                gzip.open(tmp_path / f"{f}.gz", "wb", compresslevel=4) as fout:
            shutil.copyfileobj(fin, fout)
    for name in ("index", "ref.fa"):
        (tmp_path / name).symlink_to(sc_data / name)
    out = tmp_path / "gz.bed"
    _cli(["-x", tmp_path / "index", "-r", tmp_path / "ref.fa",
          "-1", tmp_path / "r1.fq.gz", "-2", tmp_path / "r2.fq.gz",
          "-o", out])
    assert out.read_bytes() == \
        (ROOT / "tests/golden/sim_default.bed").read_bytes()


def test_forced_lowmem_spill(sc_data, tmp_path):
    """--low-mem with a 500-record spill budget (many temp shards) equals
    the in-memory golden."""
    _sim_run(sc_data, tmp_path, "sim_default.bed", ["--low-mem"],
             env=dict(ENV, CHROMAP_TPU_LOWMEM_MAX_RECORDS="500"))


BC = ["-b", "{d}/bc.fq", "--barcode-whitelist", "{d}/whitelist.txt"]
# (name, paired, arguments, spill budget of the many-shard run, whether
# the comparison run is in memory rather than one low-memory shard): the
# cases of test_feature_parity.py's other forced-spill tests
LOWMEM_CASES = [
    ("single_end", False, ["--Tn5-shift", "--remove-pcr-duplicates", "-q",
                           "0", "--low-mem"], "500", False),
    ("barcoded", True, BC + ["--remove-pcr-duplicates", "--Tn5-shift", "-l",
                             "2000", "--summary", "{out}.csv"], "500", True),
    ("pairs", True, ["--preset", "hic"], "400", False),
]


@pytest.mark.parametrize("name,paired,extra,records,in_memory",
                         LOWMEM_CASES, ids=[c[0] for c in LOWMEM_CASES])
def test_forced_lowmem_spill_equal(name, paired, extra, records, in_memory,
                                   sc_data, tmp_path):
    """Many forced spill shards (native k-way merge) equal one shard or
    the in-memory run; the barcoded summary CSVs agree as sets."""
    outs = {}
    for mode in ("multi", "single"):
        out = tmp_path / f"{name}_{mode}.out"
        args = ["-x", f"{sc_data}/index", "-r", f"{sc_data}/ref.fa",
                "-1", f"{sc_data}/r1.fq"]
        if paired:
            args += ["-2", f"{sc_data}/r2.fq"]
        args += ["-o", out] + [a.format(d=sc_data, out=out) for a in extra]
        if in_memory and mode == "multi":
            args.append("--low-mem")
        env = dict(ENV, CHROMAP_TPU_LOWMEM_MAX_RECORDS=records) \
            if mode == "multi" else ENV
        res = _cli(args, env=env)
        assert "per-record merge" not in res.stderr, res.stderr
        csv = Path(f"{out}.csv")
        outs[mode] = (out.read_bytes(), sorted(csv.read_text().splitlines())
                      if csv.exists() else None)
    assert outs["multi"] == outs["single"] and outs["multi"][0]


def test_feature_barcode_matrix(sc_data, tmp_path):
    """--matrix-output-prefix: peaks, MatrixMarket counts and barcodes
    against the frozen goldens of the JAX package's format."""
    prefix = tmp_path / "mtx"
    _cli(["-x", f"{sc_data}/index", "-r", f"{sc_data}/ref.fa",
          "-1", f"{sc_data}/r1.fq", "-2", f"{sc_data}/r2.fq",
          "-b", f"{sc_data}/bc.fq",
          "--barcode-whitelist", f"{sc_data}/whitelist.txt",
          "--remove-pcr-duplicates", "--matrix-output-prefix", prefix,
          "-o", tmp_path / "mtx.bed"])
    for suffix, golden in (("_matrix.mtx", "sim_matrix.mtx"),
                           ("_peaks.bed", "sim_matrix_peaks.bed"),
                           ("_barcode.tsv", "sim_matrix_barcode.tsv")):
        got = (tmp_path / f"mtx{suffix}").read_bytes()
        assert got == (ROOT / "tests/golden" / golden).read_bytes(), suffix
