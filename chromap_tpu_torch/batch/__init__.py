"""The batch engine: vectorized seeding over a read batch, one Myers batch
per read length (on the torch device under --device), host replay and
selection, with the exact per-read path for the reads it cannot
reproduce."""
