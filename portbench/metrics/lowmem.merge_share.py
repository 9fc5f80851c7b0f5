"""Share of the traced passes spent merging the low-memory mode's spill
files into the output, with the PCR dedup and the MAPQ filter:
HYBRID_PROFILE's span lowmem.merge over its span pass."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["lowmem.merge"][1] for s in spans if "lowmem.merge" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
