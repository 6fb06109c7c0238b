"""CLI entry: `python -m lightgbm_tpu_torch task=train config=train.conf ...`
(the reference's `lightgbm` binary, src/main.cpp), on the CUDA card."""

from .application import main

main()
