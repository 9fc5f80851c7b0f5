"""Share of the traced passes that no span of the program explains: the
self time of HYBRID_PROFILE's root span pass over its total."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    roots = [h["spans"]["pass"] for h in profs
             if "pass" in h.get("spans", {})]
    whole = sum(r[1] for r in roots)
    if not whole:
        return None
    return sum(r[2] for r in roots) / whole
