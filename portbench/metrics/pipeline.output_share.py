"""Share of the traced passes' wall time after the pipeline's own
"Mapped all reads in Xs" line: postprocessing (dedup, sort, the low-memory
spill and merge) and writing the output."""


def read(record):
    done = [p for p in record["passes"] if p["mapped_s"] is not None]
    wall = sum(p["wall_s"] for p in done)
    if not wall:
        return None
    return sum(p["wall_s"] - p["mapped_s"] for p in done) / wall
