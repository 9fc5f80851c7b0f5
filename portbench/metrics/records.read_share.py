"""Share of the traced passes spent parsing FASTQ records in the records
flow, from inside the program: HYBRID_PROFILE's span records.read over
its span pass."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["records.read"][1] for s in spans if "records.read" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
