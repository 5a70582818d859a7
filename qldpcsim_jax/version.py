"""Version resolution (reference parity: qLDPCsim/version.py:5-17, without the
undeclared tomlkit dependency)."""

from importlib import metadata

__version__ = "0.5.0"

try:  # prefer installed metadata when available
    __version__ = metadata.version("qldpcsim-jax")
except Exception:
    pass
