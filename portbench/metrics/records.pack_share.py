"""Share of the traced passes spent turning a batch of parsed FASTQ
records into the byte lists and read ids the native engine takes:
HYBRID_PROFILE's span records.pack over its span pass."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    spans = [h.get("spans", {}) for h in profs]
    part = sum(s["records.pack"][1] for s in spans if "records.pack" in s)
    whole = sum(s["pass"][1] for s in spans if "pass" in s)
    if not part or not whole:
        return None
    return part / whole
