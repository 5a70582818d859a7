"""Channel tests: depolarizing statistics, syndrome correctness, encoder
frame invariance (the property that justifies replacing Stim — SURVEY.md §7
step 2), and RNG determinism."""

import jax
import numpy as np

from qldpcsim_jax import gf2
from qldpcsim_jax.channel import CSSEncoder, sample_depolarizing, syndromes_of
from qldpcsim_jax.codes import get_code


def test_depolarizing_marginals():
    key = jax.random.PRNGKey(0)
    p = 0.3
    ex, ez = sample_depolarizing(key, p, (20000, 16))
    ex = np.asarray(ex)
    ez = np.asarray(ez)
    # X-component marginal 2p/3; Z-component 2p/3; Y overlap p/3.
    assert abs(ex.mean() - 2 * p / 3) < 0.01
    assert abs(ez.mean() - 2 * p / 3) < 0.01
    assert abs((ex & ez).mean() - p / 3) < 0.01
    # any error: p
    assert abs((ex | ez).mean() - p) < 0.01


def test_depolarizing_deterministic():
    key = jax.random.PRNGKey(42)
    a = sample_depolarizing(key, 0.1, (64, 8))
    b = sample_depolarizing(key, 0.1, (64, 8))
    assert (np.asarray(a[0]) == np.asarray(b[0])).all()
    assert (np.asarray(a[1]) == np.asarray(b[1])).all()


def test_syndromes_match_gf2():
    code = get_code("steane")
    Hx = np.asarray(code.Hx, np.float32)
    Hz = np.asarray(code.Hz, np.float32)
    key = jax.random.PRNGKey(1)
    ex, ez = sample_depolarizing(key, 0.2, (128, code.n))
    sy_z, sy_x = syndromes_of(ex, ez, Hx.T, Hz.T)
    ref_z = (np.asarray(ex).astype(np.int64) @ np.asarray(code.Hz).T.astype(np.int64)) % 2
    ref_x = (np.asarray(ez).astype(np.int64) @ np.asarray(code.Hx).T.astype(np.int64)) % 2
    assert (np.asarray(sy_z) == ref_z).all()
    assert (np.asarray(sy_x) == ref_x).all()


def test_encoder_frames_in_codespace():
    """Frames are annihilated by the checks and uniformly cover cosets."""
    for name in ("shor", "steane", "lp04_0"):
        code = get_code(name)
        enc = CSSEncoder.build(code.Hx, code.Hz)
        fx, fz = enc.encode(jax.random.PRNGKey(3), 64)
        fx, fz = np.asarray(fx), np.asarray(fz)
        assert not gf2.mat_mul(np.asarray(code.Hz), fx.T).any()
        assert not gf2.mat_mul(np.asarray(code.Hx), fz.T).any()
        if enc.k:
            assert fx.any()  # non-trivial frames get sampled


def test_frame_invariance_of_syndromes():
    """The measured syndrome of (frame XOR error) equals that of the error
    alone — the encoder never affects decode inputs, so the channel can skip
    it (replaces Stim's circuit pipeline, reference simulator.py:43-160)."""
    code = get_code("steane")
    enc = CSSEncoder.build(code.Hx, code.Hz)
    key = jax.random.PRNGKey(9)
    fx, _ = enc.encode(key, 32)
    ex, _ = sample_depolarizing(jax.random.PRNGKey(10), 0.2, (32, code.n))
    Hz = np.asarray(code.Hz).astype(np.int64)
    corrupted = np.asarray(fx).astype(np.int64) ^ np.asarray(ex).astype(np.int64)
    assert ((Hz @ corrupted.T) % 2 == (Hz @ np.asarray(ex).astype(np.int64).T) % 2).all()
