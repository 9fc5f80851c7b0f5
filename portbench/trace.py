"""The traced run's instruments and the reduction of its device trace.

`Instruments` wraps, for the passes it is switched on for, the calls into
the port's layers: the hybrid scheduler (`_map_pairs_hybrid`,
`_hybrid_flush`), the output stage (`_postprocess_and_write`,
`native_postprocess_write`), the native engine's chunk calls (time,
pairs, calls) and the four hand-written kernels' wrappers (each launch's
bytes, from its operands by `costs`). Spans are `torch.profiler`
annotations named `portbench.<span>`, so they share the device trace's
clock. `reduce_trace` turns the profiler's events into plain numbers:
the profiled window, the device's busy time (the union of kernel and copy
intervals), time and launches by kernel, and the idle gaps, each labelled
with the span that was open.
"""

from __future__ import annotations

import contextlib
import functools
import re
import time
from typing import Dict, List, Tuple

from . import costs

KERNELS = ("dense_minimizer", "cluster_scan", "myers", "myers_dropoff")
ENGINE_CALLS = ("map_pairs_raw", "map_pairs_full_raw",
                "map_pairs_dev_seeded", "map_pairs_dev_seeded_full")
SPANS = {"_map_pairs_hybrid": "hybrid", "_hybrid_flush": "hybrid",
         "_postprocess_and_write": "output"}
TOP = 10
NAME_CHARS = 120  # of a device op's name in the breakdown


def _kernel_bytes(name: str, args, out):
    """(bytes, None) of one launch, or (None, tensor) for kernel D,
    whose bytes depend on where its lanes stopped (its third output)."""
    if name == "dense_minimizer":
        L, B = args[0].shape
        return costs.dense_minimizer_bytes(L, B), None
    if name == "cluster_scan":
        H1, B = args[0].shape
        return costs.cluster_scan_bytes(H1 - 1, B), None
    if name == "myers":
        return costs.myers_bytes(args[3], args[1].shape[1], args[2]), None
    return None, out[2]


class Instruments:
    """Counters of the passes they are on for; `on` is the switch."""

    def __init__(self):
        self.on = False
        self.engine = {c: [0, 0.0, 0] for c in ENGINE_CALLS}
        self.span_s = {"hybrid": 0.0, "output": 0.0}
        self.launches: List[Tuple[str, int]] = []
        self._dropoff = []     # (rml tensor, L, e)

    def take(self) -> dict:
        """The counts since the last take, then zero them."""
        out = {"engine": {c: list(v) for c, v in self.engine.items()},
               "span_s": dict(self.span_s)}
        for v in self.engine.values():
            v[:] = [0, 0.0, 0]
        for k in self.span_s:
            self.span_s[k] = 0.0
        return out

    def kernel_bytes(self) -> Dict[str, List[float]]:
        """Bytes and launches by kernel over the launches recorded."""
        acc = {k: [0.0, 0] for k in KERNELS}
        for name, nbytes in self.launches:
            acc[name][0] += nbytes
            acc[name][1] += 1
        for rml, L, e in self._dropoff:
            steps = int((rml.long() + 1).clamp(max=L).sum().item())
            acc["myers_dropoff"][0] += costs.myers_dropoff_bytes(
                steps, rml.numel(), e)
            acc["myers_dropoff"][1] += 1
        return acc

    @contextlib.contextmanager
    def installed(self):
        """Wrap the port's layers for as long as the context lasts."""
        from torch.profiler import record_function

        from chromap_tpu_torch import native, pipeline
        from chromap_tpu_torch.ops import device_seed

        saved = []

        def patch(owner, attr, make):
            # wraps() keeps the wrapped function's attributes: a kernel
            # wrapper counts its launches on its own module-level name
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, functools.wraps(orig)(make(orig)))

        def span(label):
            def make(orig):
                def wrapped(*a, **kw):
                    if not self.on:
                        return orig(*a, **kw)
                    t0 = time.perf_counter()
                    with record_function("portbench." + label):
                        try:
                            return orig(*a, **kw)
                        finally:
                            self.span_s[label] += time.perf_counter() - t0
                return wrapped
            return make

        def engine_call(call):
            def make(orig):
                def wrapped(eng, *a, **kw):
                    if not self.on:
                        return orig(eng, *a, **kw)
                    t0 = time.perf_counter()
                    try:
                        return orig(eng, *a, **kw)
                    finally:
                        c = self.engine[call]
                        c[0] += 1
                        c[1] += time.perf_counter() - t0
                        c[2] += int(a[4])
                return wrapped
            return make

        def kernel(name):
            def make(orig):
                def wrapped(*a, **kw):
                    out = orig(*a, **kw)
                    if self.on and a[0].device.type == "cuda":
                        nbytes, rml = _kernel_bytes(name, a, out)
                        if rml is None:
                            self.launches.append((name, nbytes))
                        else:
                            self._dropoff.append((rml, a[3], a[2]))
                    return out
                return wrapped
            return make

        for meth, label in SPANS.items():
            patch(pipeline.MappingPipeline, meth, span(label))
        patch(native, "native_postprocess_write", span("output"))
        for call in ENGINE_CALLS:
            patch(native.NativeEngine, call, engine_call(call))
        for name in KERNELS:
            patch(device_seed, name, kernel(name))
        try:
            yield self
        finally:
            for owner, attr, orig in reversed(saved):
                setattr(owner, attr, orig)


def _ns(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def kineto_events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every profiler event."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        s, e = _ns(ev)
        out.append((ev.name(), ev.device_type() == DeviceType.CUDA, s, e))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label(t: int, spans: Dict[str, List[Tuple[int, int]]]) -> str:
    for label in ("output", "hybrid"):
        if any(s <= t < e for s, e in spans.get(label, ())):
            return label
    if any(s <= t < e for s, e in spans.get("pass", ())):
        return "mapping"
    return "between_passes"


def kernel_seconds(events: List[Tuple[str, bool, int, int]]) -> float:
    """Seconds in which a kernel ran on the device: the union of the
    device's intervals, copies and the spans' device images left out."""
    return sum(e - s for s, e in _union(
        [(s, e) for name, on_dev, s, e in events
         if on_dev and not is_copy(name)
         and not name.startswith("portbench.")])) * 1e-9


def reduce_trace(events: List[Tuple[str, bool, int, int]]) -> dict:
    """Window, busy time, kernels and idle gaps of a profiled stretch of
    whole passes. Device events named `portbench.*` are the profiler's
    images of the spans on the device timeline, not device work."""
    spans: Dict[str, List[Tuple[int, int]]] = {}
    device = []
    for name, on_dev, s, e in events:
        if name.startswith("portbench."):
            if not on_dev:
                spans.setdefault(name[len("portbench."):], []).append((s, e))
        elif on_dev:
            device.append((name, s, e))
    passes = spans.get("pass", [])
    if not passes:
        return {}
    w0, w1 = min(s for s, _ in passes), max(e for _, e in passes)
    busy = _union([(max(s, w0), min(e, w1)) for _, s, e in device
                   if e > w0 and s < w1])
    ops: Dict[str, List[float]] = {}
    for name, s, e in device:
        acc = ops.setdefault(name, [0.0, 0])
        acc[0] += (e - s) * 1e-9
        acc[1] += 1
    gaps, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    by_time = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "ops": {n: v for n, v in ops.items()},
            "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in by_time[:TOP]],
            "idle_gaps": [[_label((s + e) // 2, spans), (e - s) * 1e-9]
                          for s, e in gaps[:TOP]]}


def kernel_name(op: str) -> str:
    """The hand-written kernel an op of the trace is, or ''. The kernels
    sit in an anonymous namespace, so the profiler names them like
    `(anonymous namespace)::myers_kernel(int const*, ...)`."""
    for k in KERNELS:
        if re.search(r"(?<![A-Za-z0-9_])" + k + r"_kernel(?![A-Za-z0-9_])", op):
            return k
    return ""


def is_copy(op: str) -> bool:
    return op.startswith(("Memcpy", "Memset"))
