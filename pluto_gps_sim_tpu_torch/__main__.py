"""python -m pluto_gps_sim_tpu_torch — CLI entry point."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
