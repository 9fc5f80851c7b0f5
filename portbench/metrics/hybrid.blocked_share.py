"""Share of the hybrid scheduler's flushes spent blocked on device
results: HYBRID_PROFILE blocked_s over flush_wall_s."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    wall = sum(h["flush_wall_s"] for h in profs)
    if not wall:
        return None
    return sum(h["blocked_s"] for h in profs) / wall
