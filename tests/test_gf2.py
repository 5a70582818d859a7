"""GF(2) linear algebra unit tests (SURVEY.md §4.1)."""

import numpy as np
import pytest

from qldpcsim_jax import gf2


def _random_binary(rng, m, n, density=0.3):
    return (rng.random((m, n)) < density).astype(np.uint8)


def test_pack_unpack_roundtrip(rng):
    for m, n in [(1, 1), (3, 64), (5, 65), (17, 200), (40, 129)]:
        A = _random_binary(rng, m, n)
        assert (gf2.unpack_rows(gf2.pack_rows(A), n) == A).all()


def test_rank_known_matrices():
    assert gf2.rank(np.eye(5, dtype=int)) == 5
    assert gf2.rank(np.zeros((3, 4), dtype=int)) == 0
    A = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]])  # row3 = row1+row2
    assert gf2.rank(A) == 2
    assert gf2.rank(np.ones((4, 7), dtype=int)) == 1


def test_rank_nullity(rng):
    for _ in range(10):
        m, n = rng.integers(1, 40), rng.integers(1, 40)
        A = _random_binary(rng, m, n)
        K = gf2.null_space(A)
        assert gf2.rank(A) + K.shape[0] == n
        if K.size:
            assert not gf2.mat_mul(A, K.T).any()


def test_ref_transform_property(rng):
    for reduced in (False, True):
        for _ in range(8):
            m, n = int(rng.integers(1, 30)), int(rng.integers(1, 30))
            A = _random_binary(rng, m, n)
            B, T, pivots = gf2.ref(A, reduced=reduced)
            assert (B == gf2.mat_mul(T, A)).all()
            assert len(pivots) == gf2.rank(A)
            # Echelon property: pivot rows lead at pivot columns.
            for i, p in enumerate(pivots):
                assert B[i, p] == 1
                assert not B[i + 1 :, p].any()
                if reduced:
                    assert not B[:i, p].any()


def test_row_basis(rng):
    A = _random_binary(rng, 20, 15)
    B = gf2.row_basis(A)
    assert B.shape[0] == gf2.rank(A)
    assert gf2.rank(np.concatenate([A, B], axis=0)) == B.shape[0]


def test_null_space_spans_kernel(rng):
    A = _random_binary(rng, 10, 18)
    K = gf2.null_space(A)
    # Every kernel basis vector maps to zero, and dimension is exact.
    assert not gf2.mat_mul(A, K.T).any()
    assert K.shape[0] == 18 - gf2.rank(A)


def test_systematic_form(rng):
    # Build a guaranteed full-rank matrix [I | R].
    r, n = 6, 13
    R = _random_binary(rng, r, n - r)
    H = np.concatenate([np.eye(r, dtype=np.uint8), R], axis=1)
    perm_in = rng.permutation(n)
    Hp = H[:, perm_in]
    Hs, perm = gf2.systematic_form(Hp)
    assert (Hs[:, :r] == np.eye(r, dtype=np.uint8)).all()
    # perm maps row-reduced columns into systematic order.
    Rr, _, _ = gf2.rref(Hp)
    assert (Hs == Rr[:, perm]).all()


def test_systematic_form_rank_deficient():
    H = np.array([[1, 1, 0], [1, 1, 0]])
    with pytest.raises(ValueError):
        gf2.systematic_form(H)


def test_logical_ops_all_library_codes():
    from qldpcsim_jax.codes import get_code

    for name in ("shor", "steane", "bicycle", "lp04_0"):
        code = get_code(name)
        Lx, Lz = gf2.logical_ops(code.Hx, code.Hz)
        k = gf2.css_k(code.Hx, code.Hz)
        assert Lx.shape == (k, code.n)
        assert Lz.shape == (k, code.n)
        # Logicals commute with the stabilizers...
        assert not gf2.mat_mul(code.Hz, Lx.T).any()
        assert not gf2.mat_mul(code.Hx, Lz.T).any()
        # ...are symplectically paired...
        assert (gf2.mat_mul(Lx, Lz.T) == np.eye(k, dtype=np.int64)).all()
        # ...and are independent of the stabilizer group.
        assert gf2.rank(np.concatenate([code.Hx, Lx])) == gf2.rank(code.Hx) + k
        assert gf2.rank(np.concatenate([code.Hz, Lz])) == gf2.rank(code.Hz) + k


def test_css_k_matches_reference_counts():
    from qldpcsim_jax.codes import get_code

    expected = {"shor": 1, "steane": 1}
    for name, k in expected.items():
        code = get_code(name)
        assert gf2.css_k(code.Hx, code.Hz) == k
