"""The device-chunk scheduler of every `--device` flow: which chunk the
card seeds, and when its result is finished.

A flow cuts its reads into chunks of one fixed size and hands them to
`DeviceChunks.run` in read order, with a `Flow`: how to pack a chunk into
upload rows, how to map one on the host, and how to finish one from the
card's seeding. Everything else is decided here, the same way for paired
and single-end reads and for the full-native and the records flows.
"""

from __future__ import annotations

import ctypes
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np

from . import tracing

# the group size G starts here and the tuner keeps it in [G_MIN, G_MAX]
G_START, G_MIN, G_MAX = 3, 2, 12


class Chunk(NamedTuple):
    """Consecutive reads of one batch. `ends` holds one (bases, offsets)
    per read end, two for pairs and one for single reads: bases is a
    bytes object or a char pointer, offsets the n + 1 int64 offsets of
    the chunk's reads into it. `slot` keeps alive the arrays a copied
    chunk's pointers point into."""
    ends: Tuple[tuple, ...]
    base_read_id: int
    threshold: int
    cid: int
    slot: Optional[list] = None

    @property
    def n(self) -> int:
        return len(self.ends[0][1]) - 1

    def args(self) -> list:
        """The engine's read arguments: bases and offsets pointer of each
        end in turn."""
        return [a for bases, offs in self.ends
                for a in (bases, offs.ctypes.data_as(ctypes.c_void_p))]


class Flow(NamedTuple):
    """What differs between flows. `pack(*chunk.args(), n, L, out)` is
    the native packer (cn_pack_reads for pairs, cn_pack_reads_se for
    single reads; nonzero when the lengths are not uniform);
    `map_host(chunk)` maps a chunk on the host and `finish(chunk, meta,
    cand_pos, cand_meta)` maps it from its seeding, each keeping its
    result. `copy` says the chunks point into buffers that their reader
    reuses, so the scheduler copies each one it holds."""
    pack: Callable
    map_host: Callable
    finish: Callable
    copy: bool = False


class GroupTuner:
    """AIMD control of the group size G on the share of each flush that
    the main thread spent blocked on the card's results. Near-zero
    blocking means the card and its transfers kept up, so G grows and
    more chunks go to the card; heavy blocking means its queue is full,
    so G shrinks and the host takes more. The first flush pays the
    kernels' build and the index upload, so it is not read."""

    def __init__(self):
        self.g = G_START
        self._blocked = 0.0
        self._flushes = 0

    def dev_wait(self, dt: float) -> None:
        self._blocked += dt

    def flush_done(self, wall: float) -> None:
        blocked, self._blocked = self._blocked, 0.0
        self._flushes += 1
        if self._flushes <= 1 or wall <= 0:
            return
        frac = blocked / wall
        if frac > 0.15:
            self.g = max(G_MIN, self.g - 1)
        elif frac < 0.03:
            self.g = min(G_MAX, self.g + 1)


class DeviceChunks:
    """The group policy of every --device flow.

    Chunks are taken in read order in groups of G. At each group's
    flush the scheduler submits every chunk but the first to the card,
    then finishes the previous group's card chunks in chunk order, then
    maps this group's first chunk on the host. So the card works on one
    group while the host finishes the last and maps the next, a worker
    thread absorbs the waits for the downloads, and every chunk is
    finished (its mappings selected) in chunk order. Chunk order matters:
    the paired flows draw from one mt19937 stream across chunks, so
    selecting in any other order changes the output. The card's seeding
    of a chunk equals the host's, and --device turns the candidate cache
    off for the whole run, so the output does not depend on which chunks
    the card took, and G may change between groups (GroupTuner). The
    last flush of a run also finishes the chunks it submitted.

    A chunk goes to the card only when a seeder exists, its reads share
    one length L in 30..230 and the packer accepts them; else the
    host maps it in its place in the order. Every chunk is packed to one
    fixed shape, a tail chunk padded with all-ones rows, so the card
    runs one step shape throughout; one pack buffer serves every chunk,
    because `submit_packed` has copied the upload when it returns.

    `get_seeder()` returns the device seeder (built on first use) or
    None; a chunk holds up to `device_batch_size` pairs or twice as many
    single reads, and no more than `read_batch_size` pairs or reads."""

    def __init__(self, get_seeder: Callable, device_batch_size: int,
                 read_batch_size: int):
        self.get_seeder = get_seeder
        self.rows = 2 * device_batch_size
        self.read_batch_size = read_batch_size
        self.tuner = GroupTuner()
        self._buf = np.zeros(0, np.uint32)
        self._pool = []
        self._group = []
        self._pending = []
        self._executor = None

    def size(self, ends: int) -> int:
        """Pairs (ends = 2) or reads (ends = 1) in a chunk."""
        return min(self.rows // ends, self.read_batch_size)

    def run(self, chunks: Iterable[Chunk], flow: Flow,
            flush: Optional[Callable] = None) -> None:
        """Maps every chunk of `chunks` through the groups, then drains.
        `flush(flow, final)` runs each group, `self.flush` by default."""
        flush = flush or self.flush
        self._executor = ThreadPoolExecutor(max_workers=1)
        try:
            for chunk in chunks:
                self._group.append(self._copy(chunk) if flow.copy
                                   else chunk)
                if len(self._group) >= self.tuner.g:
                    flush(flow, final=False)
            flush(flow, final=True)
        finally:
            self._group, self._pending, self._pool = [], [], []
            self._executor.shutdown(wait=True)
            self._executor = None

    def flush(self, flow: Flow, final: bool) -> None:
        """One group: submit all but its first chunk, finish the previous
        group's chunks in order, map its first chunk on the host; with
        `final`, also finish the chunks just submitted."""
        with tracing.span("hybrid.flush"):
            group, self._group = self._group, []
            tracing.count("hybrid.flushes")
            tracing.count("hybrid.group_sum", self.tuner.g)
            t0 = time.time()
            submitted = [(c, self._submit(flow, c)) for c in group[1:]]
            for chunk, fut in self._pending:
                self._finish(flow, chunk, fut)
            self._pending = submitted
            if group:
                self.map_host(flow, group[0])
            if final:
                for chunk, fut in self._pending:
                    self._finish(flow, chunk, fut)
                self._pending = []
            self.tuner.flush_done(time.time() - t0)

    def _copy(self, chunk: Chunk) -> Chunk:
        """The chunk with its reads copied into a pooled slot: a list of
        [bases, offsets] arrays, one pair a read end, grown as needed."""
        slot = self._pool.pop() if self._pool else []
        ends = []
        with tracing.span("hybrid.copy", chunk.cid):
            for i, (bases, offs) in enumerate(chunk.ends):
                lo, hi = int(offs[0]), int(offs[-1])
                if len(slot) <= i:
                    slot.append([np.empty(0, np.uint8),
                                 np.empty(0, np.int64)])
                if slot[i][0].size < hi - lo:
                    slot[i][0] = np.empty(hi - lo, np.uint8)
                if slot[i][1].size < len(offs):
                    slot[i][1] = np.empty(len(offs), np.int64)
                raw, off = slot[i][0], slot[i][1][:len(offs)]
                ctypes.memmove(raw.ctypes.data,
                               ctypes.cast(bases, ctypes.c_void_p).value + lo,
                               hi - lo)
                np.subtract(offs, lo, out=off)
                ends.append((ctypes.cast(raw.ctypes.data, ctypes.c_char_p),
                             off))
        return chunk._replace(ends=tuple(ends), slot=slot)

    def _submit(self, flow: Flow, chunk: Chunk):
        """Pack and submit one chunk; the future of its resolve on the
        worker thread, or None when the host must map it."""
        offs = chunk.ends[0][1]
        n = chunk.n
        L = int(offs[1] - offs[0]) if n else 0
        # the read lengths the device step seeds
        if not 30 <= L <= 230:
            return None
        seeder = self.get_seeder()
        if seeder is None:
            return None
        ends = len(chunk.ends)
        rows = self.size(ends) * ends
        W = (L + 15) // 16 + (L + 31) // 32
        with tracing.span("seeder.pack", chunk.cid):
            if self._buf.size < rows * W:
                self._buf = np.zeros(rows * W, np.uint32)
            if flow.pack(*chunk.args(), n, L,
                         self._buf.ctypes.data_as(ctypes.c_void_p)) != 0:
                return None
            upload = self._buf[:rows * W].reshape(rows, W)
            upload[ends * n:] = 0xFFFFFFFF
        with tracing.span("seeder.submit", chunk.cid):
            handle = seeder.submit_packed(upload, rows, L)
        return self._executor.submit(seeder.resolve, handle)

    def map_host(self, flow: Flow, chunk: Chunk) -> None:
        """Map one chunk on the host, counted in chunks.cpu and, by its
        pairs (reads), in pairs.cpu."""
        with tracing.span("native.cpu_map", chunk.cid):
            flow.map_host(chunk)
        tracing.count("chunks.cpu")
        tracing.count("pairs.cpu", chunk.n)
        self._release(chunk)

    def _finish(self, flow: Flow, chunk: Chunk, fut) -> None:
        """Finish one chunk of the pending list: the host maps it if it
        never went to the card or its seeding went over budget."""
        if fut is None:
            self.map_host(flow, chunk)
            return
        t0 = time.time()
        with tracing.span("hybrid.wait", chunk.cid):
            meta, cand_pos, cand_meta, overflow = fut.result()
        self.tuner.dev_wait(time.time() - t0)
        with tracing.span("native.finish", chunk.cid):
            if overflow:
                flow.map_host(chunk)
            else:
                flow.finish(chunk, meta, cand_pos, cand_meta)
        tracing.count("chunks.dev")
        self._release(chunk)

    def _release(self, chunk: Chunk) -> None:
        if chunk.slot is not None:
            self._pool.append(chunk.slot)
