"""program.unspanned_share in the BED cell, where it moves another
end-to-end metric than in the Hi-C cell; read as
program.unspanned_share.py reads it."""

import os

from portbench.spec import _load

read = _load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "program.unspanned_share.py")).read
