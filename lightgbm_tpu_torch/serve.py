"""`python -m lightgbm_tpu_torch.serve model.txt --port 8099`: the
serving CLI (serving/server.py). It serves from the current CUDA card;
`--device cpu` serves from the CPU."""

import sys

from .serving.server import main

if __name__ == "__main__":
    sys.exit(main())
