"""program.reads_per_s in the --preset chip cell: a metric of its own
beside the one that lists the pe100 cell, read as program.reads_per_s.py
reads it."""

import os

from portbench.spec import _load

read = _load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "program.reads_per_s.py")).read
