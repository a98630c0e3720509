"""`python -m kubernetriks_tpu_torch.tune`: the autotuner's command line (run.py)."""

import sys

from kubernetriks_tpu_torch.tune.run import main

if __name__ == "__main__":
    sys.exit(main())
