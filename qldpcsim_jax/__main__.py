"""`python -m qldpcsim_jax` entry point (reference CLI parity:
`python -m qLDPCsim.simulator`, simulator.py:351-374)."""

import sys

from qldpcsim_jax.cli import main

if __name__ == "__main__":
    sys.exit(main())
