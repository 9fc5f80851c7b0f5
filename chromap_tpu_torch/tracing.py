"""Spans and counters of a mapping pass, on the host's clock.

The switch is the environment variable CHROMAP_TPU_HYBRID_PROFILE (any
non-empty value). It is read when each `map_paired_end` or
`map_single_end` call starts, so a caller may turn it on or off between
passes. Off, a span site costs one flag check and enters a shared object
that does nothing; a counter site costs the check alone.

On, a pass records each span's name, thread, start and end on
`time.perf_counter_ns`, the span open on the same thread when it opened
(its parent) and the chunk index that every span of one chunk shares.
A span's self time is its duration less what its child spans cover. At
the end of the pass one line goes to stderr:

    HYBRID_PROFILE {"pass_s": ..., "spans": {name: [count, total_s,
    self_s]}, "counters": {name: n}, "blocked_s": ..., ...}

`blocked_s`, `flush_wall_s`, `finish_s` and `submit_s` are the totals of
`hybrid.wait`, `hybrid.flush`, `native.finish` and `seeder.submit`, and
`dev_chunks` is the counter `chunks.dev`. The pass's intervals are not
printed: `last_pass()` returns them, with the totals, the counters and
the clock anchor, until the next pass starts.

The anchor ties the spans to a `torch.profiler` trace. At the start of
each pass the tracer opens and closes an empty
`record_function("chromap.clock")` and reads `perf_counter_ns` inside
it. A span's start on the profiler's clock is its start plus (the
profiler's start of `chromap.clock` - `anchor_ns`). The anchor launches
nothing, so it leaves no event on the device's timeline; the spans are
not `record_function`s for the same reason, since one that encloses
kernel launches shows on the device's timeline as if it were device work.

Spans (per pass, chunk, group or stage, never per read):

    pass             the whole map_paired_end / map_single_end call (root)
    fastq.wait       the main thread waiting for the next native FASTQ batch
    records.read     reading a batch of FASTQ records (records flows),
                     natively or as Python records
    records.pack     a batch's bases as one blob with its offsets, and
                     its read ids
    hybrid           one _map_pairs_hybrid / _map_single_hybrid call
    hybrid.copy      copying a chunk out of the reader's buffers
    hybrid.flush     one group of the device-chunk scheduler (hybrid.py)
    seeder.pack      packing a chunk into upload rows, with its padding
    seeder.submit    enqueueing a chunk's upload, step and download
    hybrid.wait      the main thread blocked on a device chunk's result
    native.finish    the native finish of a device-seeded chunk, or the
                     host map of one whose candidates overflowed
    native.cpu_map   the native engine mapping a host chunk
    records.emit     turning a batch's mapping arrays into records
    lowmem.spill     writing sorted spill files (low-memory mode)
    lowmem.merge     merging the spill files into the output
    output.concat    joining the chunks' mapping arrays
    output.native    native sort, dedup and write of the joined arrays
    output.sort      the Tn5 shift and the sort (stamped in C++ under
                     output.native; in the Python output stage also the
                     dedup, which sorts as it goes)
    output.write     filter, format and write (in C++ also the dedup,
                     fused with the write)

Counters: chunks.dev (device-seeded chunks finished), chunks.cpu (chunks
mapped on the host from the start), pairs.cpu (their pairs, reads in
single-end runs), hybrid.flushes and hybrid.group_sum (one a group, and
the group size G the scheduler had set for it), seeder.probe_kernel
(chunks submitted whose index probe ran through kernel E,
ops/device_seed.py `index_probe`), records.native_batches (a read of the
paired records flow that the native reader made, pipeline.py
`_native_pair_stream`: one a records.read span where it engages, none
where it does not), and in low-memory mode
lowmem.spills (spill files written), lowmem.spill_rows (the rows written
to them), lowmem.merge_rows_out (the lines the merge wrote) and
lowmem.merge_per_record (once a merge that took the per-record Python
merge, io/lowmem.py, instead of the native one).
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import sys
import threading
from time import perf_counter_ns
from typing import Optional

SWITCH = "CHROMAP_TPU_HYBRID_PROFILE"

# the HYBRID_PROFILE keys read before the spans existed, each the total of
# the span that times the same code
LEGACY_SPANS = {"blocked_s": "hybrid.wait", "flush_wall_s": "hybrid.flush",
                "finish_s": "native.finish", "submit_s": "seeder.submit"}

# the fields of each interval `last_pass()` returns
INTERVAL_FIELDS = ("name", "thread", "start_ns", "end_ns", "id", "parent",
                   "chunk", "self_ns")


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "chunk", "id", "parent", "start",
                 "child_ns")

    def __init__(self, tracer: "Tracer", name: str, chunk: Optional[int]):
        self.tracer = tracer
        self.name = name
        self.chunk = chunk

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        self.child_ns = 0
        stack.append(self)
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.tracer._close(self, perf_counter_ns())
        return False


class Tracer:
    """The spans, counters and anchor of the pass running now; `on` is
    the switch, set for the length of a pass."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self._last: Optional[dict] = None
        self._reset()

    def _reset(self) -> None:
        self._intervals = []
        self._counters = {}
        self._ids = itertools.count()
        self._chunks = 0
        self._anchor_ns = None

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, name, start, end, ident, parent, chunk, self_ns):
        if parent is not None:
            parent.child_ns += end - start
        self._intervals.append((
            name, threading.get_ident(), start, end, ident,
            None if parent is None else parent.id, chunk, self_ns))

    def _close(self, span: _Span, end: int) -> None:
        self._stack().pop()
        self._record(span.name, span.start, end, span.id, span.parent,
                     span.chunk, end - span.start - span.child_ns)

    def span(self, name: str, chunk: Optional[int] = None):
        """A context manager timing `name` (of chunk `chunk`)."""
        if not self.on:
            return _OFF
        return _Span(self, name, chunk)

    def traced(self, name: str):
        """Decorator: each call of the function is a span `name`."""
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                if not self.on:
                    return fn(*args, **kwargs)
                with _Span(self, name, None):
                    return fn(*args, **kwargs)
            return inner
        return wrap

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name`."""
        if not self.on:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        """A finished span from stamps on perf_counter_ns's clock (CLOCK_
        MONOTONIC, which C++'s steady_clock reads on Linux), a child of
        the span open on this thread."""
        if not self.on:
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        self._record(name, start_ns, end_ns, next(self._ids), parent,
                     None if parent is None else parent.chunk,
                     end_ns - start_ns)

    def chunk_ids(self, n: int) -> int:
        """The first of `n` fresh chunk indices of this pass (the main
        thread's routing takes them; 0 when off)."""
        if not self.on:
            return 0
        first = self._chunks
        self._chunks += n
        return first

    def traced_pass(self, fn):
        """Decorator of a pass (map_paired_end / map_single_end): reads
        the switch, and when it is on records the pass as the root span
        `pass` and logs HYBRID_PROFILE at its end."""
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            self._last = None
            if not os.environ.get(SWITCH):
                return fn(*args, **kwargs)
            self._begin()
            try:
                with _Span(self, "pass", None):
                    result = fn(*args, **kwargs)
            finally:
                self.on = False
            self._end()
            return result
        return inner

    def _begin(self) -> None:
        from torch.profiler import record_function
        self._reset()
        self._local.stack = []
        with record_function("chromap.clock"):
            self._anchor_ns = perf_counter_ns()
        self.on = True

    def _end(self) -> None:
        spans = {}
        for name, _, start, end, _, _, _, self_ns in self._intervals:
            acc = spans.setdefault(name, [0, 0, 0])
            acc[0] += 1
            acc[1] += end - start
            acc[2] += self_ns
        spans = {name: [c, total * 1e-9, own * 1e-9]
                 for name, (c, total, own) in spans.items()}
        counters = dict(self._counters)
        line = {"pass_s": spans["pass"][1], "spans": spans,
                "counters": counters}
        for key, name in LEGACY_SPANS.items():
            line[key] = spans.get(name, [0, 0.0, 0.0])[1]
        line["dev_chunks"] = counters.get("chunks.dev", 0)
        print("HYBRID_PROFILE " + json.dumps(line), file=sys.stderr)
        self._last = {"pass_s": line["pass_s"], "spans": spans,
                      "counters": counters, "anchor_ns": self._anchor_ns,
                      "intervals": self._intervals}
        self._reset()

    def last_pass(self) -> Optional[dict]:
        """The last traced pass: `pass_s`, `spans` and `counters` as
        HYBRID_PROFILE prints them, `anchor_ns` and `intervals` (tuples
        of INTERVAL_FIELDS, times in perf_counter_ns); None after a pass
        with the switch off, or while a pass runs."""
        return self._last


TRACER = Tracer()
span = TRACER.span
traced = TRACER.traced
traced_pass = TRACER.traced_pass
count = TRACER.count
add = TRACER.add
chunk_ids = TRACER.chunk_ids
last_pass = TRACER.last_pass
