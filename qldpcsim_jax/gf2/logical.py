"""Logical operator bases for CSS codes.

Restores the capability of the reference's deleted `logical_ops_css` /
`logical_ops_from_checks` modules (SURVEY.md §2.6): compute logical X/Z
operator bases from (Hx, Hz) via GF(2) nullspace / rowspace cosets. The live
reference lumps stabilizer-equivalent and logical mismatches together
(reference landmine: simulator.py:296-298) — these bases enable the honest
stabilizer-vs-logical event classification in qldpcsim_jax.engine.classify.
"""

from __future__ import annotations

import numpy as np

from qldpcsim_jax.gf2.dense import null_space, rank, row_basis, mat_mul, pack_rows, _eliminate_packed


def css_k(Hx: np.ndarray, Hz: np.ndarray) -> int:
    """Number of logical qubits k = n - rank(Hx) - rank(Hz)
    (reference: simulator.py:76)."""
    n = Hx.shape[1] if Hx.size else Hz.shape[1]
    return n - rank(Hx) - rank(Hz)


def check_css(Hx: np.ndarray, Hz: np.ndarray) -> bool:
    """CSS orthogonality: Hx @ Hz.T == 0 (mod 2)."""
    if Hx.size == 0 or Hz.size == 0:
        return True
    return not mat_mul(Hx, Hz.T).any()


def _quotient_basis(kernel_basis: np.ndarray, subspace_basis: np.ndarray) -> np.ndarray:
    """Rows of kernel_basis completing subspace_basis to a basis of the kernel.

    Greedy: keep kernel rows that increase the rank of the stack — one
    word-parallel incremental elimination pass, not repeated rank() calls.
    """
    n = kernel_basis.shape[1] if kernel_basis.size else subspace_basis.shape[1]
    base = row_basis(subspace_basis) if subspace_basis.size else np.zeros((0, n), np.uint8)
    kept = []
    stack = base
    cur_rank = stack.shape[0]
    for v in kernel_basis:
        cand = np.concatenate([stack, v[None, :]], axis=0)
        R = pack_rows(cand)
        piv, _ = _eliminate_packed(R, n, reduced=False)
        if len(piv) > cur_rank:
            kept.append(v)
            stack = cand
            cur_rank = len(piv)
    if not kept:
        return np.zeros((0, n), dtype=np.uint8)
    return np.asarray(kept, dtype=np.uint8)


def logical_ops(Hx: np.ndarray, Hz: np.ndarray):
    """Logical X and Z operator bases for a CSS code.

    Returns (Lx, Lz), each (k, n) uint8 with
      Hz @ Lx.T == 0,  Lx not in rowspace(Hx)   (X-type logicals)
      Hx @ Lz.T == 0,  Lz not in rowspace(Hz)   (Z-type logicals)
    paired so that (Lx @ Lz.T) % 2 == I_k (symplectic pairing).
    """
    Hx = np.asarray(Hx) % 2
    Hz = np.asarray(Hz) % 2
    Lx = _quotient_basis(null_space(Hz), Hx)
    Lz = _quotient_basis(null_space(Hx), Hz)
    k = Lx.shape[0]
    assert Lz.shape[0] == k, "CSS structure violated: |Lx| != |Lz|"
    if k == 0:
        return Lx, Lz
    # Symplectic pairing: make P = Lx Lz^T the identity by row-reducing P and
    # applying the same transforms to the operator bases. P is invertible over
    # GF(2) because Lx/Lz are dual quotient bases.
    P = mat_mul(Lx, Lz.T)
    # Invert P: eliminate [P | I] -> [I | P^-1].
    aug = np.concatenate([P, np.eye(k, dtype=np.uint8)], axis=1)
    R = pack_rows(aug)
    piv, _ = _eliminate_packed(R, 2 * k, reduced=True)
    from qldpcsim_jax.gf2.dense import unpack_rows

    aug_r = unpack_rows(R, 2 * k)
    assert len([p for p in piv if p < k]) == k, "pairing matrix singular"
    Pinv = aug_r[:, k:]
    Lx = mat_mul(Pinv, Lx).astype(np.uint8)
    assert (mat_mul(Lx, Lz.T) == np.eye(k, dtype=np.int64)).all()
    return Lx, Lz
