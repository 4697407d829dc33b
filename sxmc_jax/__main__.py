"""``python -m sxmc_jax`` entry point."""

import sys

from sxmc_jax.cli import main

sys.exit(main())
