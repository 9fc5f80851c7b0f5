"""Nanoseconds the low-memory merge takes per spilled row it reads:
HYBRID_PROFILE's span lowmem.merge over its counter lowmem.spill_rows."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    merge = sum(h["spans"]["lowmem.merge"][1] for h in profs
                if "lowmem.merge" in h.get("spans", {}))
    rows = sum(h.get("counters", {}).get("lowmem.spill_rows", 0)
               for h in profs)
    if not merge or not rows:
        return None
    return merge * 1e9 / rows
