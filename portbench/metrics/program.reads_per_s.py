"""Reads a second over the traced run's passes after its profiled
stretch (2 x pairs of those passes / the wall time from the end of the
profile to the end of the last pass): the rate that `reads_per_s` takes,
in a cell whose host clock spreads too widely to bound it."""


def read(record):
    w = record.get("untraced")
    if not w or not w["wall_s"]:
        return None
    return w["reads"] / w["wall_s"]
