"""library.device_ms_per_chunk in the BED cell, where it moves another end-to-end metric
than in the Hi-C cell; read as library.device_ms_per_chunk.py reads it."""

import os

from portbench.spec import _load

read = _load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "library.device_ms_per_chunk.py")).read
