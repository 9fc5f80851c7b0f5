"""The native named batch stream (chromap_tpu_torch/native NativeFastxStream,
`cn_fastx_read_batch_named` in engine.cpp) against the port's Python
reader (io/fastx.py MultiFileFastxStream): over plain and gzip files,
names cut at every kind of whitespace, CRLF endings, blank lines, empty
sequences, FASTA records, a last line with no newline, files past the
native reader's 1 MiB buffer, and two or three files cut by batches
across their boundaries, both give the same batches: the same reads, in
the same batches, with the same ids, names and bases. A malformed record
raises ValueError in both."""

import ctypes
import gzip
import random

import pytest

from chromap_tpu_torch.io.fastx import MultiFileFastxStream
from chromap_tpu_torch.native import NativeFastxStream, load_library

pytestmark = pytest.mark.skipif(load_library() is None,
                                reason="native engine unavailable")


def _fastq(rng, n, prefix, sep=b" ", eol=b"\n", blank_every=0,
           empty_every=0):
    out = []
    for i in range(n):
        if blank_every and i % blank_every == 1:
            out.append(eol)
        length = 0 if empty_every and i % empty_every == 2 else \
            rng.randrange(1, 160)
        seq = bytes(rng.choice(b"ACGTNacgt") for _ in range(length))
        name = b"@%s%d%scomment %d" % (prefix, i, sep, i)
        out.append(name + eol + seq + eol + b"+" + eol
                   + b"I" * length + eol)
    return b"".join(out)


def _files(case):
    """The case's files as (content, gzip) pairs."""
    rng = random.Random(CASES.index(case))
    if case == "plain":
        return [(_fastq(rng, 300, b"r"), False)]
    if case == "gzip":
        return [(_fastq(rng, 300, b"r"), True)]
    if case == "whitespace_in_names":
        # space, tab, \v and \f, leading blanks, and nothing after the @
        body = b"".join(_fastq(rng, 40, b"s%d_" % k, sep=sep)
                        for k, sep in enumerate(
                            (b" ", b"\t", b"\x0b", b"\x0c", b"\t ")))
        return [(body + b"@  lead\tx\nACGT\n+\nIIII\n@\nGG\n+\nII\n",
                 False)]
    if case == "no_trailing_newline":
        return [(_fastq(rng, 50, b"r") + b"@last\nACGTACGT\n+\nIIIIIIII",
                 False)]
    if case == "crlf":
        return [(_fastq(rng, 200, b"r", eol=b"\r\n"), True)]
    if case == "blank_lines":
        return [(_fastq(rng, 200, b"r", blank_every=7), False)]
    if case == "empty_sequences":
        return [(_fastq(rng, 200, b"r", empty_every=5), False)]
    if case == "fasta_records":
        return [(_fastq(rng, 30, b"q") + b">f1 x\nACGT\r\nGG\n\nTT\n"
                 b">f2\n>f3\nCCA\n" + _fastq(rng, 30, b"p"), False)]
    if case == "past_the_buffer":
        return [(_fastq(rng, 15000, b"big"), False)]
    if case == "two_files":
        return [(_fastq(rng, 130, b"a"), False),
                (_fastq(rng, 170, b"b", empty_every=9), True)]
    if case == "three_files":
        return [(_fastq(rng, 90, b"a"), True), (b"", False),
                (_fastq(rng, 50, b"b", eol=b"\r\n"), False),
                (_fastq(rng, 120, b"c", blank_every=11), True)]
    raise KeyError(case)


CASES = ["plain", "gzip", "whitespace_in_names", "no_trailing_newline",
         "crlf", "blank_lines", "empty_sequences", "fasta_records",
         "past_the_buffer", "two_files", "three_files"]


def _write(tmp_path, files):
    paths = []
    for i, (content, gz) in enumerate(files):
        path = tmp_path / (f"r{i}.fq.gz" if gz else f"r{i}.fq")
        path.write_bytes(gzip.compress(content) if gz else content)
        paths.append(str(path))
    return paths


def _python_batches(paths, size):
    stream = MultiFileFastxStream(paths)
    out = []
    while True:
        batch = stream.read_batch(size)
        if not batch:
            return out
        out.append([(r.read_id, r.name, bytes(r.seq)) for r in batch])


def _native_batches(paths, size):
    stream = NativeFastxStream(paths)
    out = []
    while True:
        batch = stream.read_batch(size)
        if not len(batch):
            stream.close()
            return out
        o = batch.offsets.tolist()
        bases = (batch.bases if isinstance(batch.bases, bytes)
                 else ctypes.string_at(batch.bases, o[-1]))
        no = batch.name_offsets.tolist()
        ids = batch.read_ids().tolist()
        assert ids[0] == batch.first_id
        out.append([(ids[i], batch.names[no[i]:no[i + 1]],
                     bases[o[i]:o[i + 1]]) for i in range(len(batch))])


@pytest.mark.parametrize("batch_size", [7, 64, 500000])
@pytest.mark.parametrize("case", CASES)
def test_native_stream_equals_python_stream(tmp_path, case, batch_size):
    paths = _write(tmp_path, _files(case))
    want = _python_batches(paths, batch_size)
    got = _native_batches(paths, batch_size)
    assert [len(b) for b in got] == [len(b) for b in want]
    assert got == want
    reads = [r for b in want for r in b]
    # ids run on across files, and an empty sequence takes none
    assert [r[0] for r in reads] == list(range(len(reads)))
    assert all(r[2] for r in reads)


@pytest.mark.parametrize("third", [b"-\n", b"\n", b""],
                         ids=["minus", "blank", "quality"])
def test_malformed_record_raises_in_both(tmp_path, third):
    good = _fastq(random.Random(5), 20, b"r")
    # a record whose third line is not '+'
    path = tmp_path / "bad.fq"
    path.write_bytes(good + b"@bad\nACGT\n" + third + b"IIII\n" + good)
    with pytest.raises(ValueError):
        _python_batches([str(path)], 1000)
    with pytest.raises(ValueError):
        _native_batches([str(path)], 1000)
