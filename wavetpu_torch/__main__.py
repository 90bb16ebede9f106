"""`python -m wavetpu_torch N Np Lx Ly Lz [T] [timesteps] [flags]`."""

import sys

from wavetpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
