"""One run of one cell: set-up, the timed window, the trace, the check.

Set-up (timed as `setup_s`, from the process's start): the configuration's
genome and the port's index of it, made once in a checkout and kept under
`_data/` (a deployment maps many samples against one reference), the
cell's reads drawn from the seed, one `MappingPipeline`, and a first warm
pass over the cell's FASTQ set, which builds the kernels and uploads the
seeder's index, followed by as many more (up to MAX_WARM_PASSES) as the
hybrid scheduler takes to settle its group size.

The window calls `map_paired_end` on that pipeline pass after pass; each
pass first deletes the output the last one wrote. The pass running when
the window's seconds are up is finished and counted. With `trace` the
first whole passes, up to TRACE_CAP_S, run under `torch.profiler` and
the instruments of trace.py, with the port's HYBRID_PROFILE log on; the
passes after them give the `untraced` rates. Where a cell's end-to-end
metric is read from the device trace, every pass, the warm ones too (so
the hybrid scheduler settles under the same load), runs under a profiler
of the device's activity alone, one profile a pass.

Then the program's state is freed and the configuration's output check
(`Spec.checker`: `checks/<name>.py`, or reference/check.py) judges the
last pass's output, named `out.<output format>`, and the metrics are
read. Last, the run fails if the process holds JAX or the JAX package,
whatever loaded it: the program, the check or a metric's reader.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import io
import json
import os
import re
import shutil
import sys
import time
from typing import Dict, List, Optional, Tuple

from .spec import Spec
from .trace import (Instruments, kernel_name, kernel_seconds, kineto_events,
                    reduce_trace)

TRACE_CAP_S = 8.0
MAX_WARM_PASSES = 12
FORBIDDEN = ("jax", "jaxlib", "flax", "chromap_tpu")

# end-to-end metrics from the window's totals (reads, wall_s, cpu_s,
# kernel_s) and the set-up; None where the run has nothing to read
END_TO_END = {
    "reads_per_s": lambda w: w["reads"] / w["wall_s"],
    "core_s_per_mread": lambda w: w["cpu_s"] / (w["reads"] / 1e6),
    "device_kernel_ms_per_mread": lambda w: (
        w["kernel_s"] * 1e3 / (w["reads"] / 1e6) if w["kernel_s"]
        else None),
    "setup_s": lambda w: w["setup_s"],
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def since_process_start() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot, against the boot-time clock)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start / os.sysconf("SC_CLK_TCK"))


def ensure_genome(data: str, g: dict, threads: int) -> str:
    """The genome's directory: ref.fa and the port's index of it."""
    from chromap_tpu_torch.config import IndexConfig
    from chromap_tpu_torch.pipeline import construct_index

    from .traffic.paired_reads import write_genome
    gdir = os.path.join(data, "genome-{genome_core}-{seed}-k{kmer_size}-"
                              "w{window_size}".format(**g))
    marker = os.path.join(gdir, "ready")
    if not os.path.exists(marker):
        os.makedirs(gdir, exist_ok=True)
        t0 = time.perf_counter()
        write_genome(os.path.join(gdir, "ref.fa"), g["genome_core"],
                     g["seed"])
        with contextlib.redirect_stderr(io.StringIO()):
            construct_index(IndexConfig(
                kmer_size=g["kmer_size"], window_size=g["window_size"],
                reference_file_path=os.path.join(gdir, "ref.fa"),
                index_output_file_path=os.path.join(gdir, "index"),
                num_threads=threads))
        with open(marker, "w") as f:
            f.write("ok\n")
        log(f"genome and index made in {time.perf_counter() - t0:.1f}s")
    return gdir


def make_reads(spec: Spec, data: str, cell: str, mix: dict, fasta: str,
               seed: int) -> List[dict]:
    """The cell's lanes for `seed`, drawn anew in every run (the same work
    each run) over the last run's."""
    rdir = os.path.join(data, "reads", cell)
    shutil.rmtree(rdir, ignore_errors=True)
    return spec.generator(mix).write_lanes(rdir, fasta, mix, seed)


def barcode_inputs(lanes: List[dict]) -> Tuple[List[str], str]:
    """The lanes' barcode reads (`bc`, in lane order) and their whitelist
    (one file, named alike by every lane); ([], "") for bulk lanes."""
    bcs = [lane.get("bc") for lane in lanes]
    lists = [lane.get("whitelist") for lane in lanes]
    for i, lane in enumerate(lanes):
        if bool(bcs[i]) != bool(bcs[0]):
            raise ValueError(f"lane {i} ({lane['r1']}): a barcode read "
                             "`bc` in some lanes and not in others")
        if lists[i] != lists[0]:
            raise ValueError(f"lane {i} ({lane['r1']}) names the whitelist "
                             f"{lists[i]!r}, lane 0 {lists[0]!r}")
    if lists[0] and not bcs[0]:
        raise ValueError("the lanes name a whitelist and no barcode read")
    return (bcs if bcs[0] else []), (lists[0] or "")


def mapping_config(conf: dict, gdir: str, lanes: List[dict], rdir: str,
                   device: str, options: Optional[dict] = None):
    """The program's MappingConfig for the lanes; its output is
    `rdir`/out.<output format>."""
    from chromap_tpu_torch.config import MappingConfig, apply_preset
    cfg = MappingConfig()
    if conf.get("preset"):
        apply_preset(cfg, conf["preset"])
    cfg.reference_file_path = os.path.join(gdir, "ref.fa")
    cfg.index_file_path = os.path.join(gdir, "index")
    cfg.read_file1_paths = [lane["r1"] for lane in lanes]
    cfg.read_file2_paths = [lane["r2"] for lane in lanes]
    bcs, whitelist = barcode_inputs(lanes)
    if bcs:
        # as the CLI's -b does: barcoded reads are single-cell data
        cfg.barcode_file_paths = bcs
        cfg.is_bulk_data = False
    if whitelist:
        cfg.barcode_whitelist_file_path = whitelist
    cfg.use_device = True
    cfg.torch_device = device
    for key, value in {**conf.get("options", {}), **(options or {})}.items():
        if not hasattr(cfg, key):
            raise KeyError(f"no mapping option {key!r}")
        setattr(cfg, key, value)
    cfg.mapping_output_file_path = os.path.join(
        rdir, "out." + cfg.output_format)
    return cfg


def seeder_stats(pipeline) -> Dict[str, int]:
    seeder = pipeline._get_seeder()
    return dict(seeder.stats) if seeder is not None else {}


def one_pass(pipeline, out: str) -> dict:
    """One map_paired_end call after deleting the last output (and any
    spill files beside it); its wall seconds, the pipeline's own mapping
    seconds and HYBRID_PROFILE line, and its seeder counts."""
    for path in glob.glob(glob.escape(out) + "*"):
        os.remove(path)
    before = seeder_stats(pipeline)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        pipeline.map_paired_end()
    wall = time.perf_counter() - t0
    text = err.getvalue()
    mapped = re.search(r"Mapped all reads in ([0-9.]+)s", text)
    prof = re.search(r"HYBRID_PROFILE (\{.*\})", text)
    after = seeder_stats(pipeline)
    return {"wall_s": wall,
            "mapped_s": float(mapped.group(1)) if mapped else None,
            "hybrid_profile": json.loads(prof.group(1)) if prof else None,
            "seeder": {k: after[k] - before.get(k, 0) for k in after},
            "log_tail": text[-2000:]}


def kernel_pass(pipeline, out: str, activities) -> dict:
    """one_pass under a profiler of `activities`, with the seconds in
    which a kernel ran on the device."""
    from torch.profiler import profile
    prof = profile(activities=activities)
    prof.start()
    try:
        rec = one_pass(pipeline, out)
    finally:
        prof.stop()
    rec["kernel_s"] = kernel_seconds(kineto_events(prof))
    return rec


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             options: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. `options` changes the
    program's mapping options (the control runs), never the reference's.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chromap_tpu_torch.pipeline import MappingPipeline

    cell = spec.cell(cell_name)
    conf = spec.config(cell["config"])
    # resolved first: a check that is misnamed fails before the mapping
    check = spec.checker(conf).check
    mix = spec.mix(cell["traffic"])
    data = os.path.join(spec.base, "_data")
    threads = os.cpu_count() or 1
    gdir = ensure_genome(data, conf["genome"], threads)
    lanes = make_reads(spec, data, cell_name, mix,
                       os.path.join(gdir, "ref.fa"), seed)
    pairs = sum(lane["pairs"] for lane in lanes)
    rdir = os.path.join(data, "runs", cell_name)
    os.makedirs(rdir, exist_ok=True)
    cfg = mapping_config(conf, gdir, lanes, rdir, device, options)
    out = cfg.mapping_output_file_path
    acts = [ProfilerActivity.CUDA if device == "cuda"
            else ProfilerActivity.CPU]
    if not trace and any(m["source"] == "device_trace"
                         for m in spec.metrics(cell_name, False)):
        def run_pass():
            return kernel_pass(pipeline, out, acts)
    else:
        def run_pass():
            return one_pass(pipeline, out)
    pipeline = MappingPipeline(cfg)
    warm = [run_pass()]
    if warm[0]["seeder"].get("chunks", 0) - warm[0]["seeder"].get(
            "over_chunks", 0) < 1:
        raise RuntimeError("the warm pass seeded no chunk on the device:\n"
                           + warm[0]["log_tail"])
    # the hybrid scheduler's group size G moves by one a flush until the
    # device's share settles; measuring while it moves times a drift
    group = pipeline._hybrid_tuner().g
    while len(warm) < MAX_WARM_PASSES:
        warm.append(run_pass())
        group, before = pipeline._hybrid_tuner().g, group
        if group == before:
            break
    setup_s = since_process_start()
    log(f"set-up {setup_s:.3f}s; warm passes "
        + " ".join(f"{p['wall_s']:.3f}" for p in warm)
        + f"; hybrid group {group}")

    inst = Instruments() if trace else None
    prof = None
    passes: List[dict] = []
    profiled: List[dict] = []
    untraced = None    # (clock, CPU time, passes) where the trace ended
    with (inst.installed() if trace else contextlib.nullcontext()):
        if trace:
            os.environ["CHROMAP_TPU_HYBRID_PROFILE"] = "1"
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else []))
            prof.start()
            inst.on = True
        t0 = time.perf_counter()
        c0 = time.process_time()
        while True:
            if inst is not None and inst.on:
                with record_function("portbench.pass"):
                    rec = one_pass(pipeline, out)
                rec.update(inst.take())
                profiled.append(rec)
                if time.perf_counter() - t0 >= TRACE_CAP_S:
                    prof.stop()
                    inst.on = False
                    untraced = (time.perf_counter(), time.process_time(),
                                len(profiled))
            else:
                rec = run_pass()
            passes.append(rec)
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        c1 = time.process_time()
        if inst is not None and inst.on:
            prof.stop()
            inst.on = False
        os.environ.pop("CHROMAP_TPU_HYBRID_PROFILE", None)
    wall, cpu = t1 - t0, c1 - c0
    reads = 2 * pairs * len(passes)
    kernel_s = sum(p.get("kernel_s", 0.0) for p in passes)
    log(f"window {wall:.3f}s, {len(passes)} passes, {reads} reads, "
        f"{cpu:.3f} core-s, {reads / wall:.1f} reads/s, "
        f"{kernel_s:.6f} kernel-s; passes "
        + " ".join(f"{p['wall_s']:.3f}" for p in passes)
        + f"; hybrid group {pipeline._hybrid_tuner().g}")

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if device == "cuda" else 0)}
    record = {"passes": profiled}
    if untraced is not None and len(passes) > untraced[2]:
        record["untraced"] = {"reads": 2 * pairs * (len(passes) - untraced[2]),
                              "wall_s": t1 - untraced[0],
                              "cpu_s": c1 - untraced[1]}
    if trace:
        record["trace"] = reduce_trace(kineto_events(prof))
        record["kernel_bytes"] = inst.kernel_bytes()
        ops = record["trace"].get("ops", {})
        log("hand-written kernels (trace s, launches; recorded launches): "
            + json.dumps({k: [sum(v[0] for o, v in ops.items()
                                  if kernel_name(o) == k),
                              sum(v[1] for o, v in ops.items()
                                  if kernel_name(o) == k),
                              record["kernel_bytes"][k][1]]
                          for k in record["kernel_bytes"]}))
        del prof, inst

    from chromap_tpu_torch.ops import device_seed
    del pipeline
    device_seed._seeder_cache.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    checks, info = check(
        conf, os.path.join(gdir, "ref.fa"), os.path.join(gdir, "refindex"),
        lanes, out, seed)
    log("output check: " + json.dumps(info))

    window = {"reads": reads, "wall_s": wall, "cpu_s": cpu,
              "kernel_s": kernel_s, "setup_s": setup_s}
    metrics = {}
    for m in spec.metrics(cell_name, trace):
        if not trace:
            value = END_TO_END[m["name"]](window)
        else:
            value = spec.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(v == 0 for v in checks.values()),
              "attempted": reads, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace and record["trace"]:
        t = record["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    # last, so that what the check and the metric readers load counts too
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise ImportError("the run imported " + ", ".join(loaded))
    return result
