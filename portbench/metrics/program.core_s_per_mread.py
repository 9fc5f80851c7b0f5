"""The process's CPU seconds (all threads) per million reads over the
traced run's passes after its profiled stretch: what
`core_s_per_mread` takes, in a cell whose host clock spreads too widely
to bound it."""


def read(record):
    w = record.get("untraced")
    if not w or not w["reads"]:
        return None
    return w["cpu_s"] / (w["reads"] / 1e6)
