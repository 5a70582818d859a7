"""Regenerate the reference's ``data/`` PCM assets from the constructors.

The reference ships 22 pre-generated ``Hx_*/Hz_*.npy`` pairs (SURVEY.md §2.5,
reference ``data/``); users load them via ``--Hx/--Hz`` file paths. This
script writes the same file layout (same stems, int64 dtype) from this
package's constructors so a reference user's file-based workflows keep
working. The stale ``*_5qb`` pair (artifact of the reference's deleted
``qLDPClib.five_qubit_code``; its 6x9 shape matches no current constructor)
is intentionally not reproduced.

Usage: python -m qldpcsim_jax.codes.export_data [outdir]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from qldpcsim_jax.codes.library import (
    qc_ldpc_lifted_code,
    qc_ldpc_tanner_code,
    shor_code,
    steane_code,
    bicycle_code,
)

# stem -> constructor returning (Hx, Hz); matches reference data/ naming.
ASSETS = {
    "shor": shor_code,
    "steane": steane_code,
    "T": qc_ldpc_tanner_code,
    "LP04_0": lambda: qc_ldpc_lifted_code("LP04", 0),
    "LP04_1": lambda: qc_ldpc_lifted_code("LP04", 1),
    "LP04_2": lambda: qc_ldpc_lifted_code("LP04", 2),
    "LP04_3": lambda: qc_ldpc_lifted_code("LP04", 3),
    "LP118_0": lambda: qc_ldpc_lifted_code("LP118", 0),
    "LP118_1": lambda: qc_ldpc_lifted_code("LP118", 1),
    "LP118_2": lambda: qc_ldpc_lifted_code("LP118", 2),
    # Bonus: the reference's BASELINE bicycle config has no data file
    # (SURVEY.md §2.5 "No bicycle-code files exist in data/").
    "bicycle": bicycle_code,
}


def export(outdir: str) -> list:
    os.makedirs(outdir, exist_ok=True)
    written = []
    for stem, ctor in ASSETS.items():
        Hx, Hz = ctor()
        for pre, M in (("Hx", Hx), ("Hz", Hz)):
            path = os.path.join(outdir, f"{pre}_{stem}.npy")
            np.save(path, np.asarray(M, dtype=np.int64))
            written.append(path)
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else os.path.join(os.getcwd(), "data")
    for path in export(outdir):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
