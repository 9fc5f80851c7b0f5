"""Share of the traced passes spent on the Tn5 shift and the sort of the
mappings: HYBRID_PROFILE's span output.sort over its span pass. (In the
native output stage the dedup is fused with the write and counts under
output.write.)"""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["output.sort"][1] for s in spans if "output.sort" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
