"""Reference-compatible API shims (qldpcsim_jax.compat): reference users'
imports and call patterns must work unchanged (qLDPCsim surface:
decoders.py, PCMlibrary.py, gf2math.py, simulator.py)."""

import numpy as np

from qldpcsim_jax.compat import PCMlibrary, PMClibrary, decoders, gf2math, simulator


def test_pcmlibrary_surface():
    Hx, Hz = PCMlibrary.shor_code()
    assert Hx.shape == (2, 9) and Hz.shape == (6, 9)
    assert PMClibrary is PCMlibrary  # the reference __init__ typo still works
    Hx, Hz = PCMlibrary.qc_ldpc_lifted_code("LP118", 0)
    assert Hx.shape == (240, 544)


def test_gf2math_surface():
    rng = np.random.default_rng(3)
    A = rng.integers(0, 2, size=(12, 20))
    r = gf2math.rank(A)
    B, T = gf2math.REF(A, reduced=True)
    assert ((T @ A) % 2 == B % 2).all()
    N = gf2math.nullSpace(A)
    assert N.shape[0] == 20 - r
    assert ((A @ N.T) % 2 == 0).all()
    rb = gf2math.rowBasis(A)
    assert rb.shape[0] == r


def test_decoder_surface_reference_signatures():
    Hx, Hz = PCMlibrary.steane_code()
    H = np.asarray(Hz)
    err = np.zeros(7, np.int64)
    err[2] = 1
    syn = (H @ err) % 2
    e, it = decoders.MS_decoder(H, syn, 0.01)
    assert (np.asarray(e) % 2 == err).all() and it >= 1
    e, it = decoders.BP_decoder(H, syn, 0.01, max_iter=30)
    assert ((H @ np.asarray(e)) % 2 == syn).all()
    e, it = decoders.BF_decoder(H, syn)
    assert ((H @ np.asarray(e)) % 2 == syn).all()
    e, it = decoders.NG_decoder(H, syn)
    assert ((H @ np.asarray(e)) % 2 == syn).all()
    # layerize + layered call like the reference engine does
    layers = decoders.layerize(H)
    e, it = decoders.MS_decoder(H, syn, 0.01, max_iter=20, layers=layers)
    assert ((H @ np.asarray(e)) % 2 == syn).all()


def test_simulator_surface(tmp_path):
    Hx, Hz = PCMlibrary.steane_code()
    c = simulator.simulate_p(Hx, Hz, 0.02, shots=200, decType="MS",
                             decIterations=8, rngSeed=0)
    assert set(c) == {"DecFailures_X", "DecFailures_Z", "decSuccessExact",
                      "decSuccessDegen", "Avg_number_of_iterations_X",
                      "Avg_number_of_iterations_Z"}
    assert 0 <= c["decSuccessExact"] <= 200
    try:
        simulator.build_stim_circuit(Hx, Hz, 0.01)
        assert False, "should raise"
    except NotImplementedError as e:
        assert "native GF(2) channel" in str(e)


def test_compat_decoders_dropin_vs_literal_reference():
    """All four compat decoders, shot-for-shot against the path-imported
    literal reference (tests/refimport.py): identical e_hat and n_iter.
    Pins the docstring's drop-in claim — in particular BF_decoder's "bool"
    residual default (decoders.py:93-95)."""
    import pytest
    from refimport import load_reference, reference_available

    if not reference_available():
        pytest.skip("reference tree not present")
    ref = load_reference()[1]
    Hx, Hz = PCMlibrary.qc_ldpc_lifted_code("LP04", 0)
    H = np.asarray(Hz) % 2
    rng = np.random.default_rng(1717)
    shots = 20
    err = rng.random((shots, H.shape[1])) < 0.04
    syns = (err.astype(np.int64) @ H.T.astype(np.int64)) % 2
    for s in range(shots):
        syn = syns[s]
        e, it = decoders.BF_decoder(H, syn)
        e_r, it_r = ref.BF_decoder(H, syn)
        assert np.array_equal(np.asarray(e) % 2,
                              np.asarray(e_r).astype(np.int64) % 2), s
        assert it == it_r, s
        e, it = decoders.NG_decoder(H, syn)
        e_r, it_r = ref.NG_decoder(H, syn)
        assert np.array_equal(np.asarray(e) % 2, np.asarray(e_r) % 2), s
        assert it == it_r, s
        e, it = decoders.MS_decoder(H, syn, 0.02, max_iter=20)
        e_r, it_r = ref.MS_decoder(H, syn, 0.02, max_iter=20,
                                   layers=[np.arange(H.shape[0])])
        assert np.array_equal(np.asarray(e) % 2, np.asarray(e_r) % 2), s
        assert it == it_r, s
        e, it = decoders.BP_decoder(H, syn, 0.02, max_iter=20)
        e_r, it_r = ref.BP_decoder(H, syn, 0.02, max_iter=20,
                                   layers=[np.arange(H.shape[0])])
        # f32 vs f64 BP can diverge on rare shots; require syndrome
        # consistency agreement instead of bit equality there
        if not (np.array_equal(np.asarray(e) % 2, np.asarray(e_r) % 2)
                and it == it_r):
            ok_my = np.array_equal((H @ (np.asarray(e) % 2)) % 2, syn)
            ok_ref = np.array_equal((H @ (np.asarray(e_r) % 2)) % 2, syn)
            assert ok_my == ok_ref, s
