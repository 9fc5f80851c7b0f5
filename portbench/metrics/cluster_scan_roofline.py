"""Kernel cluster_scan (csrc/cluster_scan.cu) against its bytes bound: the bytes of
every launch in the traced passes over 3.35 TB/s, over the kernel's time
in the profiler's trace, in percent."""

from portbench.costs import HBM_BYTES_PER_S
from portbench.trace import kernel_name

KERNEL = "cluster_scan"


def read(record):
    trace = record.get("trace") or {}
    secs = launches = 0
    for op, (s, n) in trace.get("ops", {}).items():
        if kernel_name(op) == KERNEL:
            secs += s
            launches += n
    nbytes, recorded = record.get("kernel_bytes", {}).get(KERNEL, (0, 0))
    if not secs or launches != recorded:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
