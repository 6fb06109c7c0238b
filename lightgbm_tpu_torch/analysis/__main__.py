"""``python -m lightgbm_tpu_torch.analysis`` — see cli.py."""

import sys

from .cli import main

sys.exit(main())
