"""program.core_s_per_mread in the --preset chip cell: a metric of its own
beside the one that lists the pe100 cell, read as
program.core_s_per_mread.py reads it."""

import os

from portbench.spec import _load

read = _load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "program.core_s_per_mread.py")).read
