"""Share of the traced passes spent sorting the low-memory mode's mapping
rows and writing them to spill files: HYBRID_PROFILE's span lowmem.spill
over its span pass."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["lowmem.spill"][1] for s in spans if "lowmem.spill" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
