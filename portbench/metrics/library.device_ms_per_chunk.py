"""Device milliseconds of the library kernels between the hand-written
ones (sorts, scans, gathers, elementwise) per chunk the seeder ran, from
the profiler's trace; copies are not counted."""

from portbench.trace import is_copy, kernel_name


def read(record):
    trace = record.get("trace") or {}
    chunks = sum(p["seeder"].get("chunks", 0) for p in record["passes"])
    lib = sum(s for op, (s, _) in trace.get("ops", {}).items()
              if not kernel_name(op) and not is_copy(op))
    if not chunks or not lib:
        return None
    return lib * 1e3 / chunks
