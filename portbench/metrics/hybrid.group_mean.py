"""The hybrid scheduler's mean group size G over its flushes (G-1 of
every G chunks go to the device): HYBRID_PROFILE's counters
hybrid.group_sum over hybrid.flushes."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    counters = [h.get("counters", {}) for h in profs]
    flushes = sum(c.get("hybrid.flushes", 0) for c in counters)
    if not flushes:
        return None
    return sum(c.get("hybrid.group_sum", 0) for c in counters) / flushes
