"""Share of the traced passes spent turning the hybrid scheduler's mapping
arrays into records and emitting them: HYBRID_PROFILE's span
records.emit over its span pass."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["records.emit"][1] for s in spans if "records.emit" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
