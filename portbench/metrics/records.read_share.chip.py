"""records.read_share in the --preset chip cell: a metric of its own
beside the one that lists the Hi-C cell, read as records.read_share.py
reads it."""

import os

from portbench.spec import _load

read = _load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "records.read_share.py")).read
