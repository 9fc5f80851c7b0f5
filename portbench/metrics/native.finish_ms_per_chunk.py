"""Milliseconds the native finish of one device-seeded chunk takes on the
host: HYBRID_PROFILE finish_s over dev_chunks."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    chunks = sum(h["dev_chunks"] for h in profs)
    if not chunks:
        return None
    return sum(h["finish_s"] for h in profs) * 1e3 / chunks
