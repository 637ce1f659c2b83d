"""``python -m photon_ml_tpu_torch.analysis``: the lint runs only when this
module is the program, so importing it (as a walk over the package does)
runs nothing."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
