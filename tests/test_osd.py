"""OSD post-decoder parity tests: batched bit-packed OSD vs the per-shot
NumPy oracle, plus the syndrome-consistency property (SURVEY.md §4.2)."""

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import DecoderConfig, TannerGraph, make_ms_decoder, make_osd

import oracle


def _failed_shots(codename, p, n_shots, max_iter, seed):
    """Generate shots and return decoder-failed ones with their posteriors."""
    rng = np.random.default_rng(seed)
    code = get_code(codename)
    H = np.asarray(code.Hz)
    m, n = H.shape
    errs = (rng.random((n_shots, n)) < p).astype(np.int8)
    syn = ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)
    graph = TannerGraph.build(H)
    decode = make_ms_decoder(graph, DecoderConfig(max_iter=max_iter))
    res = decode(syn, p)
    conv = np.asarray(res.converged)
    failed = ~conv
    return (H, np.asarray(res.e_hat)[failed], syn[failed],
            np.asarray(res.posterior)[failed])


@pytest.mark.parametrize("order", [0, 1, 2])
def test_osd_matches_oracle(order):
    # Aggressive noise + few iterations so plenty of shots fail into OSD.
    H, e_hat, syn, post = _failed_shots("lp04_0", 0.09, 64, 3, seed=7)
    assert e_hat.shape[0] >= 4, "need some failed shots for the test"
    osd = make_osd(H, order)
    out = np.asarray(osd(e_hat, syn, post))
    for s in range(e_hat.shape[0]):
        ref = oracle.osd_decode(H, e_hat[s].copy(), syn[s], post[s], order)
        assert (out[s] == ref).all(), f"shot {s} OSD-{order} mismatch"


def test_osd_syndrome_consistency():
    """OSD-0 on achievable syndromes returns syndrome-consistent vectors."""
    H, e_hat, syn, post = _failed_shots("lp04_0", 0.09, 64, 3, seed=11)
    osd = make_osd(H, 0)
    out = np.asarray(osd(e_hat, syn, post)).astype(np.int64)
    syn_out = (out @ np.asarray(H, np.int64).T) % 2
    assert (syn_out == syn).all()


def test_osd_order_improves_weight():
    """Higher order can only lower (or keep) the best candidate weight."""
    H, e_hat, syn, post = _failed_shots("lp04_0", 0.09, 48, 3, seed=13)
    w = {}
    for order in (0, 2):
        out = np.asarray(make_osd(H, order)(e_hat, syn, post))
        w[order] = out.sum(axis=1)
    assert (w[2] <= w[0]).all()


def test_osd_order_guard():
    """Orders above 6 must raise (2^order trace-time unroll), and negative
    orders are rejected with a clear message."""
    H = np.asarray(get_code("steane").Hz) % 2
    with pytest.raises(ValueError, match="compile time"):
        make_osd(H, 8)
    with pytest.raises(ValueError, match=">= 0"):
        make_osd(H, -1)


def test_apply_osd_odd_batch_window():
    """The engine's windowed OSD pass with a batch size sharing no factors
    with 256 (previously a 1-shot-window performance cliff, ADVICE #3) is
    identical to applying OSD to the failed shots directly."""
    import jax.numpy as jnp

    from qldpcsim_jax.engine.montecarlo import ShotPipeline, SimConfig

    code = get_code("lp04_0")
    B = 250  # gcd(250, 256) = 2: the old path would have run 125 windows
    cfg = SimConfig(shots=B, batch_size=B, dec_type="BP", dec_iterations=5,
                    osd_order=1, rng_seed=3)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    H = np.asarray(code.Hz) % 2
    rng = np.random.default_rng(11)
    err = rng.random((B, H.shape[1])) < 0.06
    syn = (err.astype(np.int64) @ H.T.astype(np.int64)) % 2
    res = pipe.dec_x(jnp.asarray(syn, jnp.float32), 0.02)
    failed = ~np.asarray(res.converged)
    assert failed.any(), "need some failed shots to exercise the window"
    out = np.asarray(pipe._apply_osd(pipe.osd_x, res.e_hat, res.posterior,
                                     jnp.asarray(syn, jnp.float32),
                                     jnp.asarray(failed)))
    direct = np.asarray(res.e_hat).copy()
    fi = np.nonzero(failed)[0]
    direct[fi] = np.asarray(pipe.osd_x(np.asarray(res.e_hat)[fi],
                                       syn[fi].astype(np.float32),
                                       np.asarray(res.posterior)[fi]))
    assert (out == direct).all()
