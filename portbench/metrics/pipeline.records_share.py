"""Share of the traced passes' wall time spent mapping outside
MappingPipeline._map_pairs_hybrid: the Python records flow around the
hybrid scheduler (reading FASTQ into records, building and emitting
them)."""


def read(record):
    done = [p for p in record["passes"] if p["mapped_s"] is not None]
    wall = sum(p["wall_s"] for p in done)
    if not wall or not any(p["span_s"]["hybrid"] for p in done):
        return None
    return sum(p["mapped_s"] - p["span_s"]["hybrid"] for p in done) / wall
