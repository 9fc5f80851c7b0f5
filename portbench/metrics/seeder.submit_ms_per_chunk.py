"""Milliseconds the host takes to enqueue one chunk's seeding step (its
upload, ~514 launches and download): HYBRID_PROFILE submit_s over
dev_chunks."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    chunks = sum(h["dev_chunks"] for h in profs)
    if not chunks:
        return None
    return sum(h["submit_s"] for h in profs) * 1e3 / chunks
