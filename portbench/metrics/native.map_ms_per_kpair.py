"""Milliseconds the native engine takes to map 1,000 pairs on the host
(map_pairs_raw and map_pairs_full_raw: the host's chunks and any chunk
over the device's budget)."""


def read(record):
    secs = pairs = 0
    for p in record["passes"]:
        for call in ("map_pairs_raw", "map_pairs_full_raw"):
            secs += p["engine"][call][1]
            pairs += p["engine"][call][2]
    if not pairs:
        return None
    return secs * 1e6 / pairs
