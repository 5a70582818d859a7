"""Shot-for-shot parity against the LITERAL reference decoders.

Every other parity test in this suite validates against re-implementations of
the reference's semantics (tests/oracle.py, csrc/gf2core.cpp). This module
closes that loop: it path-imports the reference's own numpy-only modules
(/root/reference/qLDPCsim/{gf2math,decoders}.py via tests/refimport.py) and
asserts the framework produces IDENTICAL e_hat and n_iter, per shot, on
random syndromes from every library code family.

Measured agreement map (random depolarizing syndromes, p=0.05):
  * MS: the mixed-dtype NumPy replica (oracle.ms_decode_mixed — the
    reference's exact f32/f64 mix: f64 L_ch scalar makes msg_v2c float64
    from the first VN update on while msg_c2v stays float32) is bit-exact
    vs the literal MS_decoder on every code and schedule, INCLUDING bicycle
    where the framework's pure-f32 path diverges ~46% of shots through the
    CN exact-value tie condition |msg|==min (every bicycle row starts with
    18 equal-magnitude messages; dtype decides the ties). The framework f32
    edge path is bit-exact on the overwhelming majority of shots on the
    non-degenerate codes (typically 100%, occasionally a tie/rounding shot)
    and is asserted here within a small budget.
  * BP: the native C++ strict-reference-numerics decoder (float64, eps=1e-9,
    clamp-by-subtraction) is bit-exact everywhere tested. The framework's
    f32 edge path (eps=1e-6 clamp, f32 transcendentals — DIVERGENCES.md)
    is bit-exact on most shots; divergent shots can separate in iteration
    count too (iterative decoding is chaotic near non-convergence), so the
    budget counts shots where either e_hat or n_iter differ.
  * BF (bool residual) and NG: bit-exact on all codes tested (pure integer
    semantics — no precision surface).
  * OSD-0: bit-exact. Reference OSD-lambda for lambda>=1 is its OSD-0 (even
    lambda) or a fixed scrambled variant — the enumeration aliasing bug
    (landmine L4): e_hat_perm_tmp/e_hat_perm_minW all alias one buffer, so
    the returned vector is the LAST candidate, whose cumulative info-bit
    flips XOR to zero for even 2^lambda. Asserted here against the literal
    code; the framework's corrected enumeration returns weight-<= candidates.
"""

from __future__ import annotations

import numpy as np
import pytest

import oracle
from refimport import load_reference, reference_available
from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import (TannerGraph, DecoderConfig, make_decoder,
                                   make_osd, layerize)
from qldpcsim_jax.gf2.native import bp_decode_native, ms_decode_native

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference tree not present")

P = 0.05
MAX_IT = 30


def _ref():
    return load_reference()[1]


def _syndromes(H, p, shots, seed):
    rng = np.random.default_rng(seed)
    err = rng.random((shots, H.shape[1])) < 2 * p / 3
    return (err.astype(np.int64) @ H.T.astype(np.int64)) % 2


def _ref_layers(H, schedule):
    if schedule == "F":
        return [np.arange(H.shape[0])]
    return layerize(H, serial=(schedule == "S"))


def _framework_decode(H, syn, dec_type, schedule, max_iter=MAX_IT, **kw):
    cfg = DecoderConfig(dec_type=dec_type, max_iter=max_iter,
                        schedule=schedule, impl="edge", round1_iters=-1,
                        platform="cpu", **kw)
    dec = make_decoder(TannerGraph.build(H), cfg)
    r = dec(syn, P / 3)
    return np.asarray(r.e_hat) % 2, np.asarray(r.n_iter), r


# (code, shots per schedule) — sized so the whole module stays ~1 min; the
# reference MS is dense-O(m*n) per layer per shot.
MS_EXACT = [("shor", "F", 200), ("shor", "L", 200), ("shor", "S", 200),
            ("steane", "F", 200), ("steane", "L", 200), ("steane", "S", 200),
            ("lp04_0", "F", 150), ("lp04_0", "L", 150), ("lp04_0", "S", 40),
            ("lp118_0", "F", 100), ("lp118_0", "L", 100), ("lp118_0", "S", 12),
            ("tanner", "F", 30), ("tanner", "L", 30)]


@pytest.mark.parametrize("code_name,schedule,shots", MS_EXACT)
def test_ms_matches_reference(code_name, schedule, shots):
    """vs literal MS_decoder (decoders.py:110-182), per shot:
      * oracle.ms_decode_mixed (reference-dtype replica): identical e_hat
        and n_iter on EVERY shot — the literal-reference pinning;
      * framework f32 edge path: identical on all but a small budget of
        tie/rounding shots; mismatched converged shots must still be
        syndrome-consistent."""
    ref = _ref()
    H = np.asarray(get_code(code_name).Hz) % 2
    syn = _syndromes(H, P, shots, seed=hash((code_name, schedule)) % 2**31)
    layers = _ref_layers(H, schedule)
    e_my, it_my, r = _framework_decode(H, syn, "MS", schedule)
    conv_my = np.asarray(r.converged)
    budget = max(3, int(0.08 * shots))
    n_mismatch = 0
    for s in range(shots):
        e_r, it_r = ref.MS_decoder(H, syn[s], P / 3, max_iter=MAX_IT,
                                   layers=layers)
        e_r = np.asarray(e_r) % 2
        e_m, it_m = oracle.ms_decode_mixed(H, syn[s], P / 3, MAX_IT, layers)
        assert np.array_equal(e_r, e_m % 2), f"replica e_hat, shot {s}"
        assert it_r == it_m, f"replica n_iter, shot {s}"
        if not (np.array_equal(e_r, e_my[s]) and it_r == it_my[s]):
            n_mismatch += 1
            if conv_my[s]:
                assert np.array_equal(
                    (H.astype(np.int64) @ e_my[s]) % 2, syn[s]), f"shot {s}"
    assert n_mismatch <= budget, f"{n_mismatch} f32-divergent shots"


def test_ms_bicycle_mixed_precision_replica():
    """Bicycle (the maximally tie-degenerate code, excluded from MS_EXACT):
    the mixed-dtype replica is bit-exact vs the literal reference — the f32
    framework path diverges on exact-value ties only (module docstring)."""
    ref = _ref()
    H = np.asarray(get_code("bicycle").Hz) % 2
    shots = 100
    syn = _syndromes(H, P, shots, seed=97)
    layers = [np.arange(H.shape[0])]
    for s in range(shots):
        e_r, it_r = ref.MS_decoder(H, syn[s], P / 3, max_iter=MAX_IT,
                                   layers=layers)
        e_m, it_m = oracle.ms_decode_mixed(H, syn[s], P / 3, MAX_IT, layers)
        assert np.array_equal(np.asarray(e_r) % 2, e_m % 2), f"shot {s}"
        assert it_r == it_m, f"shot {s}"


def test_ms_bicycle_statistical():
    """Bicycle MS framework vs literal reference: despite per-shot tie
    divergence, syndrome-consistency and failure rates agree statistically
    (both are valid min-sum fixed points)."""
    ref = _ref()
    H = np.asarray(get_code("bicycle").Hz) % 2
    shots = 300
    syn = _syndromes(H, P, shots, seed=98)
    layers = [np.arange(H.shape[0])]
    e_my, it_my, r = _framework_decode(H, syn, "MS", "F")
    conv_my = np.asarray(r.converged)
    n_conv_ref = 0
    for s in range(shots):
        e_r, it_r = ref.MS_decoder(H, syn[s], P / 3, max_iter=MAX_IT,
                                   layers=layers)
        ok = np.array_equal((H.astype(np.int64) @ (np.asarray(e_r) % 2)) % 2,
                            syn[s])
        n_conv_ref += int(ok)
        if conv_my[s]:
            assert np.array_equal(
                (H.astype(np.int64) @ e_my[s]) % 2, syn[s]), f"shot {s}"
    # two-proportion agreement on convergence rate (4-sigma)
    a, b = n_conv_ref / shots, conv_my.mean()
    pool = (a + b) / 2
    bound = 4 * np.sqrt(max(pool * (1 - pool), 1 / shots) * 2 / shots)
    assert abs(a - b) <= bound, (a, b, bound)


BP_CODES = [("shor", 150), ("steane", 150), ("bicycle", 50), ("lp118_0", 50)]


@pytest.mark.parametrize("code_name,shots", BP_CODES)
def test_bp_native_strict_matches_reference(code_name, shots):
    """Native C++ strict-numerics BP == literal BP_decoder
    (decoders.py:189-290), identical e_hat and n_iter."""
    ref = _ref()
    H = np.asarray(get_code(code_name).Hz) % 2
    syn = _syndromes(H, P, shots, seed=hash(code_name) % 2**31)
    layers = _ref_layers(H, "F")
    nat = bp_decode_native(H, syn, P / 3, MAX_IT, layers)
    if nat is None:
        pytest.skip("native gf2core unavailable")
    e_n, it_n = np.asarray(nat[0]) % 2, np.asarray(nat[1])
    for s in range(shots):
        e_r, it_r = ref.BP_decoder(H, syn[s], P / 3, max_iter=MAX_IT,
                                   layers=layers)
        assert np.array_equal(np.asarray(e_r) % 2, e_n[s]), f"shot {s}"
        assert it_r == it_n[s], f"shot {s}"


@pytest.mark.parametrize("code_name,shots", BP_CODES)
def test_bp_edge_f32_vs_reference(code_name, shots):
    """Framework f32 edge BP vs literal reference: bit-exact on all but a
    small budget of shots (f32 transcendentals + eps=1e-6 clamp vs f64
    eps=1e-9, DIVERGENCES.md; divergent shots can separate in iteration
    count too). Differing converged shots must stay syndrome-consistent."""
    ref = _ref()
    H = np.asarray(get_code(code_name).Hz) % 2
    syn = _syndromes(H, P, shots, seed=hash(code_name) % 2**31 + 1)
    layers = _ref_layers(H, "F")
    e_my, it_my, r = _framework_decode(H, syn, "BP", "F")
    conv_my = np.asarray(r.converged)
    budget = max(3, int(0.08 * shots))
    n_mismatch = 0
    for s in range(shots):
        e_r, it_r = ref.BP_decoder(H, syn[s], P / 3, max_iter=MAX_IT,
                                   layers=layers)
        if not (np.array_equal(np.asarray(e_r) % 2, e_my[s])
                and it_r == it_my[s]):
            n_mismatch += 1
            if conv_my[s]:
                assert np.array_equal(
                    (H.astype(np.int64) @ e_my[s]) % 2, syn[s]), f"shot {s}"
    assert n_mismatch <= budget, f"{n_mismatch} mismatched shots"


ALL_CODES = [("shor", 200), ("steane", 200), ("bicycle", 150),
             ("lp04_0", 150), ("lp118_0", 100)]


@pytest.mark.parametrize("code_name,shots", ALL_CODES)
def test_bf_bool_matches_reference(code_name, shots):
    """Framework BF with bf_residual='bool' == literal BF_decoder
    (decoders.py:74-102), identical e_hat and n_iter."""
    ref = _ref()
    H = np.asarray(get_code(code_name).Hz) % 2
    syn = _syndromes(H, P, shots, seed=hash(code_name) % 2**31 + 2)
    e_my, it_my, _ = _framework_decode(H, syn, "BF", "F",
                                       bf_residual="bool")
    for s in range(shots):
        out = ref.BF_decoder(H, syn[s])
        e_r, it_r = out
        assert np.array_equal(np.asarray(e_r).astype(np.int64) % 2,
                              e_my[s]), f"shot {s}"
        assert it_r == it_my[s], f"shot {s}"


@pytest.mark.parametrize("code_name,shots", ALL_CODES)
def test_ng_matches_reference(code_name, shots):
    """Framework NG == literal NG_decoder (decoders.py:27-66), identical
    e_hat and step count."""
    ref = _ref()
    H = np.asarray(get_code(code_name).Hz) % 2
    syn = _syndromes(H, P, shots, seed=hash(code_name) % 2**31 + 3)
    e_my, it_my, _ = _framework_decode(H, syn, "NG", "F")
    for s in range(shots):
        e_r, it_r = ref.NG_decoder(H, syn[s])
        assert np.array_equal(np.asarray(e_r) % 2, e_my[s]), f"shot {s}"
        assert it_r == it_my[s], f"shot {s}"


def _failed_shots(code_name, p, shots, seed, max_iter=6):
    """MS-failed shots with posteriors, as OSD inputs."""
    H = np.asarray(get_code(code_name).Hz) % 2
    syn = _syndromes(H, p, shots, seed)
    cfg = DecoderConfig(dec_type="MS", max_iter=max_iter, schedule="F",
                        impl="edge", round1_iters=-1, platform="cpu")
    dec = make_decoder(TannerGraph.build(H), cfg)
    r = dec(syn, p / 3)
    fails = np.nonzero(~np.asarray(r.converged))[0]
    return (H, np.asarray(r.e_hat)[fails] % 2, syn[fails],
            np.asarray(r.posterior)[fails])


def test_osd0_matches_reference():
    """Framework OSD-0 == literal OSDdec(order=0) (decoders.py:299-369) on
    MS-failed lp04 shots. (The reference mutates its e_hat argument in
    place — landmine L4 — so it gets copies.)"""
    ref = _ref()
    H, e0, sf, post = _failed_shots("lp04_0", 0.08, 400, seed=11)
    e0, sf, post = e0[:10], sf[:10], post[:10]
    osd = make_osd(H, 0)
    e_my = np.asarray(osd(e0, sf, post)) % 2
    for k in range(len(sf)):
        e_r = ref.OSDdec(H, e0[k].copy().astype(np.int64), sf[k],
                         post[k].astype(np.float64), 0)
        assert np.array_equal(np.asarray(e_r) % 2, e_my[k]), f"shot {k}"


def test_reference_osd2_is_osd0():
    """The literal reference's OSD-2 output equals its OSD-0 output: the
    enumeration buffer aliasing (decoders.py:348,361,366) makes the
    returned vector the final candidate, whose cumulative info-bit flips
    XOR(0..3)=0 cancel. Pins DIVERGENCES.md landmine L4 against the real
    code."""
    ref = _ref()
    H, e0, sf, post = _failed_shots("lp04_0", 0.08, 400, seed=12)
    e0, sf, post = e0[:8], sf[:8], post[:8]
    for k in range(len(sf)):
        a = ref.OSDdec(H, e0[k].copy().astype(np.int64), sf[k],
                       post[k].astype(np.float64), 0)
        b = ref.OSDdec(H, e0[k].copy().astype(np.int64), sf[k],
                       post[k].astype(np.float64), 2)
        assert np.array_equal(np.asarray(a) % 2, np.asarray(b) % 2), k


def test_osd2_never_heavier_than_reference():
    """Framework OSD-2 (corrected enumeration) returns candidates that are
    syndrome-consistent and never heavier than the reference's."""
    ref = _ref()
    H, e0, sf, post = _failed_shots("lp04_0", 0.08, 400, seed=13)
    e0, sf, post = e0[:10], sf[:10], post[:10]
    osd = make_osd(H, 2)
    e_my = np.asarray(osd(e0, sf, post)) % 2
    for k in range(len(sf)):
        e_r = np.asarray(ref.OSDdec(H, e0[k].copy().astype(np.int64), sf[k],
                                    post[k].astype(np.float64), 2)) % 2
        assert np.array_equal((H.astype(np.int64) @ e_my[k]) % 2, sf[k]), k
        assert e_my[k].sum() <= e_r.sum(), k


def test_ms_native_matches_reference():
    """Native C++ MS == literal MS_decoder on lp118 (the C++ oracle used by
    benchmarks/parity.py MS rows), identical e_hat and n_iter."""
    ref = _ref()
    H = np.asarray(get_code("lp118_0").Hz) % 2
    shots = 60
    syn = _syndromes(H, P, shots, seed=21)
    layers = _ref_layers(H, "F")
    nat = ms_decode_native(H, syn, P / 3, MAX_IT, layers)
    if nat is None:
        pytest.skip("native gf2core unavailable")
    e_n, it_n = np.asarray(nat[0]) % 2, np.asarray(nat[1])
    for s in range(shots):
        e_r, it_r = ref.MS_decoder(H, syn[s], P / 3, max_iter=MAX_IT,
                                   layers=layers)
        assert np.array_equal(np.asarray(e_r) % 2, e_n[s]), f"shot {s}"
        assert it_r == it_n[s], f"shot {s}"
