"""dense_minimizer_roofline in the BED cell, where it moves another end-to-end metric
than in the Hi-C cell; read as dense_minimizer_roofline.py reads it."""

import os

from portbench.spec import _load

read = _load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "dense_minimizer_roofline.py")).read
