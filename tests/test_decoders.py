"""Batched decoder parity tests against the per-shot NumPy oracle
(SURVEY.md §4.2), plus property tests (zero syndrome, correctable errors)."""

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    layerize,
    make_bf_decoder,
    make_bp_decoder,
    make_decoder,
    make_ms_decoder,
    make_ng_decoder,
)

import oracle


def _sample_shots(rng, H, n_shots, weight_p=0.06):
    """Random error vectors + their true syndromes."""
    m, n = H.shape
    errs = (rng.random((n_shots, n)) < weight_p).astype(np.int8)
    syn = (errs.astype(np.int64) @ H.T.astype(np.int64)) % 2
    return errs, syn.astype(np.int8)


def _layers_of(H, schedule):
    if schedule == "F":
        return [np.arange(H.shape[0])]
    return layerize(H, serial=(schedule == "S"))


@pytest.mark.parametrize("codename,schedule", [
    ("steane", "F"),
    ("steane", "L"),
    ("shor", "S"),
    ("lp04_0", "F"),
    ("lp04_0", "L"),
    ("lp04_0", "S"),
])
def test_ms_matches_oracle(rng, codename, schedule):
    code = get_code(codename)
    H = np.asarray(code.Hz)
    graph = TannerGraph.build(H)
    cfg = DecoderConfig(dec_type="MS", max_iter=12, schedule=schedule)
    decode = make_ms_decoder(graph, cfg)
    errs, syn = _sample_shots(rng, H, 48)
    res = decode(syn, 0.02)
    e_hat = np.asarray(res.e_hat)
    n_iter = np.asarray(res.n_iter)
    conv = np.asarray(res.converged)
    layers = _layers_of(H, schedule)
    for s in range(syn.shape[0]):
        e_ref, it_ref, _post, conv_ref = oracle.ms_decode(H, syn[s], 0.02, 12, layers)
        assert conv[s] == conv_ref, f"shot {s}: convergence mismatch"
        assert n_iter[s] == it_ref, f"shot {s}: iteration count mismatch"
        assert (e_hat[s] == e_ref).all(), f"shot {s}: e_hat mismatch"


@pytest.mark.parametrize("codename,schedule", [
    ("steane", "F"),
    ("shor", "L"),
    ("lp04_0", "F"),
])
def test_bp_matches_oracle(rng, codename, schedule):
    code = get_code(codename)
    H = np.asarray(code.Hz)
    graph = TannerGraph.build(H)
    cfg = DecoderConfig(dec_type="BP", max_iter=10, schedule=schedule)
    decode = make_bp_decoder(graph, cfg)
    errs, syn = _sample_shots(rng, H, 32)
    res = decode(syn, 0.02)
    e_hat = np.asarray(res.e_hat)
    n_iter = np.asarray(res.n_iter)
    layers = _layers_of(H, schedule)
    mismatch = 0
    for s in range(syn.shape[0]):
        e_ref, it_ref, _post, _c = oracle.bp_decode(H, syn[s], 0.02, 10, layers)
        if not ((e_hat[s] == e_ref).all() and n_iter[s] == it_ref):
            mismatch += 1
    # BP is float-heavy; tolerate rare association-order sign flips.
    assert mismatch <= 1, f"{mismatch}/32 BP shots diverged from oracle"


@pytest.mark.parametrize("codename", ["steane", "bicycle"])
def test_bf_matches_oracle(rng, codename):
    code = get_code(codename)
    H = np.asarray(code.Hz)
    graph = TannerGraph.build(H)
    decode = make_bf_decoder(graph, DecoderConfig(dec_type="BF"))
    errs, syn = _sample_shots(rng, H, 64)
    res = decode(syn)
    e_hat = np.asarray(res.e_hat)
    n_iter = np.asarray(res.n_iter)
    for s in range(syn.shape[0]):
        e_ref, it_ref, _c = oracle.bf_decode(H, syn[s])
        assert (e_hat[s] == e_ref).all(), f"shot {s}"
        assert n_iter[s] == it_ref, f"shot {s}"


@pytest.mark.parametrize("codename", ["steane", "bicycle"])
def test_bf_bool_residual_matches_oracle(rng, codename):
    """bf_residual='bool' reproduces the reference's any-overlap residual
    (decoders.py:93-95) shot-for-shot, iteration-for-iteration."""
    code = get_code(codename)
    H = np.asarray(code.Hz)
    graph = TannerGraph.build(H)
    decode = make_bf_decoder(graph, DecoderConfig(dec_type="BF",
                                                  bf_residual="bool"))
    errs, syn = _sample_shots(rng, H, 64)
    res = decode(syn)
    e_hat = np.asarray(res.e_hat)
    n_iter = np.asarray(res.n_iter)
    for s in range(syn.shape[0]):
        e_ref, it_ref, _c = oracle.bf_decode(H, syn[s], residual="bool")
        assert (e_hat[s] == e_ref).all(), f"shot {s}"
        assert n_iter[s] == it_ref, f"shot {s}"


def test_bf_residual_semantics_diverge():
    """Pin the case where the two BF residuals genuinely differ: a row with
    overlap 2 is satisfied under the parity residual (2 mod 2 == 0) but
    "unsatisfied" under the reference's any-overlap residual when its
    syndrome bit is 0 (DIVERGENCES.md "BF residual").

    H = [[1,1,0],[0,1,1]], syndrome (1,1): step 1 flips the degree-2
    variable v1 (nuc = (1,2,1), half-deg (0.5,1,0.5) -> flips v0,v1,v2...
    use a syndrome where the trajectories split instead."""
    H = np.array([[1, 1, 0],
                  [0, 1, 1]], dtype=np.int8)
    # syndrome (1, 0): nuc = (1,1,0), half-deg (.5,1,.5) -> flip v0 only.
    # e = (1,0,0): overlaps = (1,0) -> BOTH residuals converge here. Use
    # syndrome (1, 1): nuc = (1,2,1) -> flip all three; e = (1,1,1):
    # overlaps = (2,2): parity residual = (0,0)^ (1,1) -> (1,1) unsat;
    # bool residual = (1,1)^(1,1) = (0,0) -> CONVERGED with a wrong-parity
    # answer. The decoders must disagree on convergence at iteration 1.
    syn = np.array([[1, 1]], dtype=np.int8)
    graph = TannerGraph.build(H)
    r_mod2 = make_bf_decoder(graph, DecoderConfig(dec_type="BF"))(syn)
    r_bool = make_bf_decoder(
        graph, DecoderConfig(dec_type="BF", bf_residual="bool"))(syn)
    assert bool(np.asarray(r_bool.converged)[0]) is True
    assert int(np.asarray(r_bool.n_iter)[0]) == 1
    assert (np.asarray(r_bool.e_hat)[0] == [1, 1, 1]).all()
    # the bool fixed point violates the actual parity-check equation:
    assert ((H @ np.asarray(r_bool.e_hat)[0]) % 2 != syn[0]).any()
    # mod2 keeps iterating (and its result, if converged, satisfies parity)
    conv2 = bool(np.asarray(r_mod2.converged)[0])
    if conv2:
        assert ((H @ np.asarray(r_mod2.e_hat)[0]) % 2 == syn[0]).all()
    assert int(np.asarray(r_mod2.n_iter)[0]) != 1 or not conv2

    # oracle agrees with both
    e_b, it_b, c_b = oracle.bf_decode(H, syn[0], residual="bool")
    assert c_b and it_b == 1 and (e_b == [1, 1, 1]).all()


@pytest.mark.parametrize("codename", ["steane", "bicycle"])
def test_ng_matches_oracle(rng, codename):
    code = get_code(codename)
    H = np.asarray(code.Hz)
    graph = TannerGraph.build(H)
    decode = make_ng_decoder(graph, DecoderConfig(dec_type="NG"))
    errs, syn = _sample_shots(rng, H, 64)
    res = decode(syn)
    e_hat = np.asarray(res.e_hat)
    n_iter = np.asarray(res.n_iter)
    for s in range(syn.shape[0]):
        e_ref, steps_ref = oracle.ng_decode(H, syn[s])
        assert (e_hat[s] == e_ref).all(), f"shot {s}"
        assert n_iter[s] == steps_ref, f"shot {s}"


def test_zero_syndrome_fast_convergence():
    """Zero syndrome -> zero error in <=1 iteration (SURVEY.md §4.2)."""
    code = get_code("steane")
    H = np.asarray(code.Hz)
    graph = TannerGraph.build(H)
    zero = np.zeros((4, H.shape[0]), np.int8)
    for make, needs_p in [(make_ms_decoder, True), (make_bp_decoder, True),
                          (make_bf_decoder, False), (make_ng_decoder, False)]:
        cfg = DecoderConfig(max_iter=20)
        decode = make(graph, cfg) if make in (make_bf_decoder, make_ng_decoder) \
            else make(graph, cfg)
        res = decode(zero, 0.01) if needs_p else decode(zero)
        assert not np.asarray(res.e_hat).any()
        assert np.asarray(res.converged).all()
        expected_iters = 0 if make is make_ng_decoder else 1
        assert (np.asarray(res.n_iter) == expected_iters).all()


def test_single_errors_decode_exactly():
    """Weight-1 errors below half-distance decode exactly on Shor/Steane."""
    for codename in ("shor", "steane"):
        code = get_code(codename)
        H = np.asarray(code.Hz)
        n = H.shape[1]
        errs = np.eye(n, dtype=np.int8)
        syn = (errs @ H.T) % 2
        graph = TannerGraph.build(H)
        decode = make_ms_decoder(graph, DecoderConfig(max_iter=30))
        res = decode(syn, 0.01)
        e_hat = np.asarray(res.e_hat)
        assert np.asarray(res.converged).all()
        # Decoded error must reproduce the syndrome exactly.
        assert ((e_hat @ H.T) % 2 == syn).all()


def test_layerize_properties():
    """Layer partition property: no column touched twice within a layer;
    serial => single-row layers; layers cover all rows contiguously."""
    for codename in ("shor", "steane", "lp04_0", "tanner"):
        H = np.asarray(get_code(codename).Hz)
        for serial in (False, True):
            layers = layerize(H, serial=serial)
            cat = np.concatenate(layers)
            assert (cat == np.arange(H.shape[0])).all()
            for l in layers:
                if serial:
                    assert l.size == 1
                if l.size:
                    assert H[l].sum(axis=0).max() <= 1 or l.size == 1


def test_schedule_padding():
    H = np.asarray(get_code("lp04_0").Hz)
    sched = build_layers(H, "L")
    assert sched.rows.shape[0] == len(layerize(H))
    assert (sched.rows[sched.rows < H.shape[0]] < H.shape[0]).all()
    flat = sched.rows[sched.rows < H.shape[0]]
    assert sorted(flat.tolist()) == list(range(H.shape[0]))


def _random_sparse_H(rng, m, n, row_w=4, zero_rows=1, zero_cols=1):
    """Adversarial random parity-check matrix: irregular row weights, plus
    explicit all-zero rows/columns and degree-1 variables — the structural
    edge cases the padded edge layout must absorb."""
    H = np.zeros((m, n), np.int8)
    for i in range(m):
        w = rng.integers(1, row_w + 1)
        H[i, rng.choice(n, size=w, replace=False)] = 1
    for i in rng.choice(m, size=min(zero_rows, m), replace=False):
        H[i] = 0
    for j in rng.choice(n, size=min(zero_cols, n), replace=False):
        H[:, j] = 0
    # force one degree-1 variable
    free = np.nonzero(H.sum(axis=0) == 0)[0]
    if free.size and H[0].sum() == 0:
        H[0, free[0]] = 1
    return H


@pytest.mark.parametrize("seed,schedule", [(0, "F"), (1, "L"), (2, "S")])
def test_fuzz_random_H_ms_bp_match_oracle(seed, schedule):
    """MS/BP edge implementations stay oracle-bit-exact on random irregular
    matrices (not just the structured library codes)."""
    rng = np.random.default_rng(seed)
    H = _random_sparse_H(rng, m=24, n=40)
    graph = TannerGraph.build(H)
    layers = _layers_of(H, schedule)
    errs, syn = _sample_shots(rng, H, 24, weight_p=0.08)
    sched = build_layers(H, schedule)
    for make, orc in ((make_ms_decoder, oracle.ms_decode),
                      (make_bp_decoder, oracle.bp_decode)):
        dec = make(graph, DecoderConfig(max_iter=8, schedule=schedule),
                   layers=sched)
        res = dec(syn, 0.02)
        e_hat = np.asarray(res.e_hat)
        n_iter = np.asarray(res.n_iter)
        mismatch = 0
        for s in range(syn.shape[0]):
            e_ref, it_ref, _post, _c = orc(H, syn[s], 0.02, 8, layers)
            if not ((e_hat[s] == e_ref).all() and n_iter[s] == it_ref):
                mismatch += 1
        assert mismatch <= 1, f"{make.__name__}: {mismatch}/24 diverged"


@pytest.mark.parametrize("seed", [3, 4])
def test_fuzz_random_H_bf_ng_match_oracle(seed):
    rng = np.random.default_rng(seed)
    H = _random_sparse_H(rng, m=20, n=32)
    graph = TannerGraph.build(H)
    errs, syn = _sample_shots(rng, H, 32, weight_p=0.1)
    dec_bf = make_bf_decoder(graph, DecoderConfig(dec_type="BF"))
    dec_ng = make_ng_decoder(graph, DecoderConfig(dec_type="NG"))
    rb = dec_bf(syn)
    rn = dec_ng(syn)
    for s in range(syn.shape[0]):
        e_ref, it_ref, _c = oracle.bf_decode(H, syn[s])
        assert (np.asarray(rb.e_hat)[s] == e_ref).all(), f"BF shot {s}"
        assert int(np.asarray(rb.n_iter)[s]) == it_ref, f"BF iters shot {s}"
        e_ng, steps = oracle.ng_decode(H, syn[s])
        assert (np.asarray(rn.e_hat)[s] == e_ng).all(), f"NG shot {s}"


@pytest.mark.parametrize("dec_type", ["MS", "BP", "BF", "NG"])
def test_empty_parity_matrix(dec_type):
    """m=0 parity-check matrices decode to the zero error (the reference
    guards H.size==0 in every decoder, decoders.py:86-87,138-139,215-216 —
    though its guard returns a bare array, landmine L7; here the result is
    a normal DecodeResult)."""
    H = np.zeros((0, 9), np.int8)
    g = TannerGraph.build(H)
    dec = make_decoder(g, DecoderConfig(dec_type=dec_type, max_iter=5,
                                        platform="cpu", round1_iters=-1))
    r = dec(np.zeros((4, 0), np.int8), 0.01)
    assert np.asarray(r.e_hat).shape == (4, 9)
    assert (np.asarray(r.e_hat) % 2 == 0).all()
    assert np.asarray(r.converged).all()


def test_one_sided_code_end_to_end():
    """A CSS pair with NO X checks (Hx empty — the reference's circuit
    builder guards this case, simulator.py:58-68) runs through the full
    engine: X errors decode through Hz as usual, Z errors have no
    constraints (e_hat_z = 0) and only X-side statistics accumulate."""
    from qldpcsim_jax.engine.montecarlo import SimConfig, simulate_p

    Hz = np.array([[1, 1, 0, 1, 0, 1, 1],
                   [0, 1, 1, 1, 1, 0, 1],
                   [1, 0, 1, 1, 1, 1, 0]], np.int8)
    Hx = np.zeros((0, 7), np.int8)
    r = simulate_p(Hx, Hz, 0.02, SimConfig(shots=256, dec_iterations=5,
                                           batch_size=128, rng_seed=0))
    c = r.counters
    assert c["DecFailures_Z"] == 0  # no X checks -> Z decode trivially OK
    assert 0 <= c["decSuccessExact"] <= 256
    assert 0.0 <= r.qbler <= 1.0
