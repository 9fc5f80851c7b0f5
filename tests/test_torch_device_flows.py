"""The device flows beyond bulk BED and Hi-C through the port's CLI with
`--device --torch-device cpu` (the kernels' plain versions): the cases of
tests/test_device_flows.py that need one device. Each run seeds its
chunks through the port's seeder -- it must log "Using CPU (plain torch)
device seeding" -- with a small device batch so that the 5000-pair
simulated set spans many hybrid chunks, and its output must byte-match
the reference chromap golden (the barcoded summary CSV as a set: the
reference writes barcodes in hash-table order)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from simulate import (write_simulated_barcodes,  # noqa: E402
                      write_simulated_dataset,
                      write_simulated_multichrom_dataset)

ROOT = Path(__file__).resolve().parent.parent
DEVICE_ARGS = ["--device", "--torch-device", "cpu",
               "--device-batch-size", "512"]
SEEDED = "Using CPU (plain torch) device seeding"
ENV = dict(os.environ, OMP_NUM_THREADS="2")


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simtorchdev")
    write_simulated_dataset(str(d))
    write_simulated_barcodes(str(d))
    _index(d)
    return d


@pytest.fixture(scope="module")
def mc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simtorchdevmc")
    write_simulated_multichrom_dataset(str(d))
    _index(d)
    return d


def _index(d):
    subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
                    "-r", f"{d}/ref.fa", "-o", f"{d}/index"],
                   check=True, capture_output=True, cwd=ROOT, env=ENV)


def _run(d, out, extra, paired=True):
    args = [sys.executable, "-m", "chromap_tpu_torch.cli",
            "-x", f"{d}/index", "-r", f"{d}/ref.fa", "-1", f"{d}/r1.fq"]
    if paired:
        args += ["-2", f"{d}/r2.fq"]
    args += ["-o", str(out)] + [a.format(d=d) for a in extra]
    res = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                         env=ENV)
    assert res.returncode == 0, res.stderr
    return res


BARCODES = ["-b", "{d}/bc.fq", "--barcode-whitelist", "{d}/whitelist.txt"]
CASES = [
    # atac preset: low-memory mode, adapter trimming, dedup, Tn5
    ("sim_atac.bed", "sim_data", True, ["--preset", "atac"]),
    # chip: low-memory mode and dedup
    ("sim_chip.bed", "sim_data", True,
     ["-l", "2000", "--remove-pcr-duplicates", "--low-mem"]),
    # trimmed PAF: per-pair trim demotion and trimmed-length stitching
    ("sim_trim.paf", "sim_data", True, ["--trim-adapters", "--PAF"]),
    # SAM: the extended finish and the per-chunk CIGAR/NM/MD merge
    ("sim_pe.sam", "sim_data", True, ["--SAM"]),
    # --chr-order: candidate rids reranked after paired reduction
    ("sim_chrorder.bed", "mc_data", True,
     ["--chr-order", "{d}/chr_order.txt"]),
    # single-end barcoded fragments (cell dedup) and SAM through the
    # single-end device submission
    ("sim_se_barcode.bed", "sim_data", False,
     BARCODES + ["--remove-pcr-duplicates"]),
    ("sim_se_bc.sam", "sim_data", False, BARCODES + ["--SAM"]),
    # --read-format slices rewrite the reads before seeding
    ("sim_readformat.bed", "sim_data", True,
     ["-b", "{d}/bc.fq", "--read-format", "r1:5:84,r2:0:79,bc:0:7"]),
]


@pytest.mark.parametrize("golden,data,paired,extra", CASES,
                         ids=[c[0] for c in CASES])
def test_device_flow_matches_golden(golden, data, paired, extra, request,
                                    golden_dir, tmp_path):
    d = request.getfixturevalue(data)
    out = tmp_path / golden
    res = _run(d, out, extra + DEVICE_ARGS, paired)
    assert SEEDED in res.stderr, res.stderr
    assert out.read_bytes() == (golden_dir / golden).read_bytes()


def test_device_barcoded_matches_golden(sim_data, golden_dir, tmp_path):
    """scATAC fragments: barcode correction, whitelist, cell-level dedup,
    Tn5 and the per-barcode summary."""
    out = tmp_path / "bc.bed"
    summary = tmp_path / "bc.csv"
    res = _run(sim_data, out, BARCODES + [
        "--remove-pcr-duplicates", "--Tn5-shift", "-l", "2000",
        "--summary", str(summary)] + DEVICE_ARGS)
    assert SEEDED in res.stderr, res.stderr
    assert out.read_bytes() == (golden_dir / "sim_barcode.bed").read_bytes()
    assert sorted(summary.read_text().splitlines()) == sorted(
        (golden_dir / "sim_barcode_summary.csv").read_text().splitlines())


def test_device_sharded_run_matches_golden(sim_data, golden_dir, tmp_path):
    """--num-shards 2: each shard maps its reads with device chunks and
    spills a sorted shard; --merge-shards joins them into the one-run
    golden."""
    out = tmp_path / "sharded.bed"
    for i in range(2):
        res = _run(sim_data, out, ["--num-shards", "2", "--shard-index",
                                   str(i)] + DEVICE_ARGS)
        assert SEEDED in res.stderr, res.stderr
    _run(sim_data, out, ["--merge-shards",
                         f"{out}.shard0.temp0,{out}.shard1.temp0"])
    assert out.read_bytes() == (golden_dir / "sim_default.bed").read_bytes()


def test_device_equals_host_no_cache_on_cache_active_data(sim_data,
                                                          tmp_path):
    """Duplicate-heavy reads activate the candidate cache; --device turns
    it off, so the device run equals the host run with --no-cache."""
    for i in (1, 2):
        with open(f"{sim_data}/r{i}.fq") as f:
            lines = f.read().splitlines()
        recs = [lines[j:j + 4] for j in range(0, 800, 4)]
        with open(tmp_path / f"r{i}.fq", "w") as f:
            for n in range(30 * len(recs)):
                r = recs[n % len(recs)]
                f.write(f"@dup{n}\n{r[1]}\n+\n{r[3]}\n")
    for name in ("index", "ref.fa"):
        (tmp_path / name).symlink_to(sim_data / name)
    outs = {}
    for tag, extra in (("host", ["--no-cache"]), ("dev", DEVICE_ARGS)):
        out = tmp_path / f"cache_{tag}.bed"
        res = _run(tmp_path, out, ["--read-batch-size", "1000"] + extra)
        if tag == "dev":
            assert SEEDED in res.stderr, res.stderr
        outs[tag] = out.read_bytes()
    assert outs["dev"] == outs["host"] and outs["host"]
