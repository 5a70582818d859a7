"""CSS code library: parity-check-matrix constructors and loaders.

Reference parity: qLDPCsim/PCMlibrary.py:25-203 (constructors) and
qLDPCsim/simulator.py:20-35 (matrix loader).
"""

from qldpcsim_jax.codes.library import (
    Code,
    shor_code,
    steane_code,
    bicycle_code,
    qc_ldpc_tanner_code,
    qc_ldpc_lifted_code,
    get_code,
    CODE_REGISTRY,
)
from qldpcsim_jax.codes.loader import load_matrix, code_from_files

__all__ = [
    "Code",
    "shor_code",
    "steane_code",
    "bicycle_code",
    "qc_ldpc_tanner_code",
    "qc_ldpc_lifted_code",
    "get_code",
    "CODE_REGISTRY",
    "load_matrix",
    "code_from_files",
]
