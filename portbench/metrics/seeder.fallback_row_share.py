"""Rows (reads) of the device's chunks flagged back to the exact host
path: DeviceSeeder.stats fallback_rows over rows."""


def read(record):
    rows = sum(p["seeder"].get("rows", 0) for p in record["passes"])
    if not rows:
        return None
    return sum(p["seeder"].get("fallback_rows", 0)
               for p in record["passes"]) / rows
