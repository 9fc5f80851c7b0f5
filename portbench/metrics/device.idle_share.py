"""Share of the traced window in which no kernel or copy ran on the
device: 1 - (union of their intervals) / window."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
