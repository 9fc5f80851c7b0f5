"""Chunks the device seeder seeded within its budget (DeviceSeeder.stats)
over the chunks the native engine mapped (its calls, one a chunk)."""


def read(record):
    passes = record["passes"]
    mapped = sum(c[0] for p in passes for c in p["engine"].values())
    if not mapped:
        return None
    seeded = sum(p["seeder"].get("chunks", 0) - p["seeder"].get(
        "over_chunks", 0) for p in passes)
    return seeded / mapped
