"""``python -m repro_torch.core.traffic`` — the traffic x failure grid CLI."""
import sys

from .grid import main

sys.exit(main())
