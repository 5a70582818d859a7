"""GF(2) linear algebra and code-library parity against the LITERAL
reference modules (path-imported, tests/refimport.py) — the companion of
tests/test_reference_parity.py for layers L0/L1 of SURVEY.md.

Environment note: the reference's `expand_base` (PCMlibrary.py:129-138)
passes a NumPy scalar shift into np.roll's slice arithmetic, which numpy
2.0.2 rejects (the reference targets numpy>=2.3.5). The library tests wrap
np.roll with an int()-casting shim for the duration of the reference call —
a pure environment-compatibility shim, not a semantic change (np.roll with
an integer shift is shift-value-identical).
"""

from __future__ import annotations

import numpy as np
import pytest

from refimport import _load_by_path, load_reference, reference_available

from qldpcsim_jax import gf2
from qldpcsim_jax.codes import get_code

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference tree not present")


def _ref_gf2math():
    return load_reference()[0]


def _ref_pcm():
    import sys

    if "qLDPCsim.PCMlibrary" in sys.modules:
        return sys.modules["qLDPCsim.PCMlibrary"]
    return _load_by_path("qLDPCsim.PCMlibrary",
                         "/root/reference/qLDPCsim/PCMlibrary.py")


def _rand_mats(seed, count=12):
    rng = np.random.default_rng(seed)
    shapes = [(1, 1), (3, 7), (7, 3), (8, 8), (12, 20), (20, 12), (16, 33)]
    mats = []
    for i in range(count):
        m, n = shapes[i % len(shapes)]
        mats.append(rng.integers(0, 2, size=(m, n)).astype(np.int64))
    return mats


def test_rank_matches_reference():
    ref = _ref_gf2math()
    for A in _rand_mats(3):
        assert gf2.rank(A) == ref.rank(A.copy()), A.shape


def test_rref_matches_reference():
    """Reduced REF is unique for a given matrix, so the reference's
    B (gf2math.py:139-187) must equal ours entry-for-entry; T satisfies
    B = (T @ A) % 2 on both sides."""
    ref = _ref_gf2math()
    for A in _rand_mats(5):
        B_ref, T_ref = ref.REF(A.copy(), reduced=True)
        assert ((T_ref @ A) % 2 == B_ref % 2).all()
        B_my, T_my, _ = gf2.rref(A)
        assert (B_my % 2 == B_ref % 2).all(), A.shape
        assert ((T_my @ A) % 2 == B_my % 2).all()


def _span_equal(U, V, n):
    """Row spans of U and V over GF(2) are equal."""
    U = np.atleast_2d(np.asarray(U) % 2).reshape(-1, n)
    V = np.atleast_2d(np.asarray(V) % 2).reshape(-1, n)
    ru, rv = gf2.rank(U), gf2.rank(V)
    return ru == rv == gf2.rank(np.vstack([U, V]))


def test_nullspace_matches_reference_span():
    ref = _ref_gf2math()
    for A in _rand_mats(7):
        n = A.shape[1]
        N_ref = ref.nullSpace(A.copy())
        N_my = gf2.null_space(A)
        assert N_ref.shape[0] == N_my.shape[0] == n - gf2.rank(A)
        if N_ref.size:
            assert ((A @ N_ref.T) % 2 == 0).all()
            assert _span_equal(N_ref, N_my, n)


def test_rowbasis_matches_reference_span():
    ref = _ref_gf2math()
    for A in _rand_mats(9):
        n = A.shape[1]
        R_ref = ref.rowBasis(A.copy())
        R_my = gf2.row_basis(A)
        assert R_ref.shape[0] == R_my.shape[0] == gf2.rank(A)
        if R_ref.size:
            assert _span_equal(R_ref, A, n)
            assert _span_equal(R_my, R_ref, n)


def test_systematic_form_matches_reference_contract():
    """Both systematic forms produce [I | *] under their own column
    permutation with the same row space as the input (full-row-rank
    inputs, the function's domain)."""
    ref = _ref_gf2math()
    rng = np.random.default_rng(11)
    for _ in range(6):
        m, n = 5, 11
        # full-row-rank input
        while True:
            A = rng.integers(0, 2, size=(m, n)).astype(np.int64)
            if gf2.rank(A) == m:
                break
        H_ref, perm_ref = ref.systematic_form(A.copy())
        assert (np.asarray(H_ref)[:, :m] % 2 == np.eye(m, dtype=int)).all()
        assert _span_equal(H_ref, A[:, perm_ref], n)
        H_my, perm_my = gf2.systematic_form(A)
        assert (np.asarray(H_my)[:, :m] % 2 == np.eye(m, dtype=int)).all()
        assert _span_equal(H_my, A[:, perm_my], n)


class _RollIntShim:
    """np.roll wrapper casting the shift to int (see module docstring)."""

    def __enter__(self):
        self._orig = np.roll
        np.roll = lambda a, shift, **kw: self._orig(  # type: ignore
            a, int(shift) if np.isscalar(shift) or getattr(
                shift, "ndim", 1) == 0 else shift, **kw)
        return self

    def __exit__(self, *exc):
        np.roll = self._orig
        return False


@pytest.mark.parametrize("name,call", [
    ("shor", lambda p: p.shor_code()),
    ("steane", lambda p: p.steane_code()),
    ("bicycle", lambda p: p.bicycle_code()),
])
def test_small_codes_match_reference(name, call):
    pcm = _ref_pcm()
    Hx_ref, Hz_ref = call(pcm)
    code = get_code(name)
    assert (np.asarray(Hx_ref) % 2 == np.asarray(code.Hx) % 2).all()
    assert (np.asarray(Hz_ref) % 2 == np.asarray(code.Hz) % 2).all()


@pytest.mark.parametrize("name,family,index", [
    ("lp04_0", "LP04", 0), ("lp04_1", "LP04", 1),
    ("lp04_2", "LP04", 2), ("lp04_3", "LP04", 3),
    ("lp118_0", "LP118", 0), ("lp118_1", "LP118", 1),
    ("lp118_2", "LP118", 2),
])
def test_lifted_codes_match_reference(name, family, index):
    pcm = _ref_pcm()
    with _RollIntShim():
        Hx_ref, Hz_ref = pcm.qc_ldpc_lifted_code(family, index)
    code = get_code(name)
    assert (np.asarray(Hx_ref) % 2 == np.asarray(code.Hx) % 2).all()
    assert (np.asarray(Hz_ref) % 2 == np.asarray(code.Hz) % 2).all()


def test_tanner_code_matches_reference():
    pcm = _ref_pcm()
    with _RollIntShim():
        Hx_ref, Hz_ref = pcm.qc_ldpc_tanner_code()
    code = get_code("tanner")
    assert (np.asarray(Hx_ref) % 2 == np.asarray(code.Hx) % 2).all()
    assert (np.asarray(Hz_ref) % 2 == np.asarray(code.Hz) % 2).all()
