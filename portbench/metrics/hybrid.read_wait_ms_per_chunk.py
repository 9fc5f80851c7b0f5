"""Milliseconds the main thread waits for the next FASTQ batch, per chunk
the native engine maps: HYBRID_PROFILE's span fastq.wait over the
counters chunks.dev + chunks.cpu."""


def read(record):
    profs = [p["hybrid_profile"] for p in record["passes"]
             if p["hybrid_profile"]]
    wait = sum(h["spans"]["fastq.wait"][1] for h in profs
               if "fastq.wait" in h.get("spans", {}))
    chunks = sum(h.get("counters", {}).get(c, 0) for h in profs
                 for c in ("chunks.dev", "chunks.cpu"))
    if not wait or not chunks:
        return None
    return wait * 1e3 / chunks
