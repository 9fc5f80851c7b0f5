"""Share of the traced passes spent removing duplicates and filtering,
formatting and writing the output lines (one fused loop in the native
output stage): HYBRID_PROFILE's span output.write over its span pass."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["output.write"][1] for s in spans if "output.write" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
