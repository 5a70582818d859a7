"""Native C++ GF(2) core parity tests (csrc/gf2core.cpp via ctypes)."""

import numpy as np
import pytest

from qldpcsim_jax import gf2
from qldpcsim_jax.gf2 import native
from qldpcsim_jax.gf2.dense import pack_rows

import oracle

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native gf2core not built")


def test_native_rank_matches_python(rng):
    for _ in range(20):
        m, n = int(rng.integers(1, 60)), int(rng.integers(1, 120))
        A = (rng.random((m, n)) < 0.3).astype(np.uint8)
        P = pack_rows(A)
        import os
        os.environ["QLDPC_NATIVE"] = "0"
        try:
            # pure-python path
            from qldpcsim_jax.gf2.dense import _eliminate_packed
            piv, _ = _eliminate_packed(P.copy(), n, reduced=False)
        finally:
            os.environ["QLDPC_NATIVE"] = "1"
        assert native.rank_native(P, n) == len(piv)


def test_native_eliminate_transform(rng):
    A = (rng.random((12, 20)) < 0.4).astype(np.uint8)
    R = pack_rows(A)
    T = pack_rows(np.eye(12, dtype=np.uint8))
    piv = native.eliminate_native(R, 20, T, reduced=True)
    from qldpcsim_jax.gf2.dense import unpack_rows

    B = unpack_rows(R, 20)
    Tm = unpack_rows(T, 12)
    assert (B == gf2.mat_mul(Tm, A)).all()
    for i, p in enumerate(piv):
        assert B[i, p] == 1
        col = B[:, p].copy()
        col[i] = 0
        assert not col.any()


def test_native_ms_matches_oracle(rng):
    from qldpcsim_jax.codes import get_code
    from qldpcsim_jax.decoders import layerize

    H = np.asarray(get_code("lp04_0").Hz)
    n = H.shape[1]
    errs = (rng.random((24, n)) < 0.05).astype(np.int8)
    syn = ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)
    layers = layerize(H)
    out = native.ms_decode_native(H, syn, 0.02, 12, layers)
    assert out is not None
    e_hat, iters, conv, post = out
    for s in range(syn.shape[0]):
        e_ref, it_ref, post_ref, conv_ref = oracle.ms_decode(H, syn[s], 0.02, 12, layers)
        assert conv[s] == conv_ref, s
        assert iters[s] == it_ref, s
        assert (e_hat[s] == e_ref).all(), s
        # posterior: plumbing check only — C++ accumulates the VN sums
        # sequentially while NumPy uses pairwise summation, so f32 values
        # differ in the ~5th decimal (decisions/iters above are exact).
        assert np.allclose(post[s], post_ref, rtol=1e-3, atol=1e-3), s


def test_native_abi_handshake():
    """The loaded library's exported ABI version must match the binding's
    expectation (gf2/native.py rebuilds on mismatch — an mtime check alone
    cannot catch a stale .so after a checkout)."""
    from qldpcsim_jax.gf2 import native

    lib = native.get_lib()
    if lib is None:
        import pytest

        pytest.skip("native gf2core unavailable")
    assert native._abi_version(lib) == native._ABI_VERSION
