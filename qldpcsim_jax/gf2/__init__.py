"""GF(2) linear algebra.

Host-side (NumPy, bit-packed uint64 word-parallel) routines used for static
preprocessing — rank/RREF/nullspace/logical operators — and device-side helpers
live in `qldpcsim_jax.gf2.device`.

Reference parity: qLDPCsim/gf2math.py:12-244 (rank, REF, nullSpace, rowBasis,
systematic_form) plus the deleted `logical_ops_css` capability (SURVEY.md §2.6).
The implementations here are fresh, word-parallel designs, not translations of
the reference's per-element Python loops.
"""

from qldpcsim_jax.gf2.dense import (
    pack_rows,
    unpack_rows,
    rank,
    ref,
    rref,
    null_space,
    row_basis,
    systematic_form,
    mat_mul,
    mat_vec,
)
from qldpcsim_jax.gf2.logical import logical_ops, css_k, check_css

__all__ = [
    "pack_rows",
    "unpack_rows",
    "rank",
    "ref",
    "rref",
    "null_space",
    "row_basis",
    "systematic_form",
    "mat_mul",
    "mat_vec",
    "logical_ops",
    "css_k",
    "check_css",
]
