"""Two-round straggler compaction must be bit-identical to single-round
full-depth decoding (decoders/tworound.py invariant)."""

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import DecoderConfig, TannerGraph, make_decoder


def _shots(rng, H, n_shots, p):
    n = H.shape[1]
    errs = (rng.random((n_shots, n)) < p).astype(np.int8)
    return ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)


@pytest.mark.parametrize("dec,codename,p", [
    ("MS", "lp04_0", 0.05),
    ("MS", "lp04_0", 0.12),   # high failure rate exercises the slow path
    ("BP", "steane", 0.08),
])
def test_tworound_equals_full(dec, codename, p):
    rng = np.random.default_rng(99)
    H = np.asarray(get_code(codename).Hz)
    graph = TannerGraph.build(H)
    syn = _shots(rng, H, 256, p)
    single = make_decoder(graph, DecoderConfig(dec_type=dec, max_iter=40,
                                               round1_iters=-1))
    two = make_decoder(graph, DecoderConfig(dec_type=dec, max_iter=40,
                                            round1_iters=6,
                                            compact_cap_frac=0.25))
    r1 = single(syn, 0.02)
    r2 = two(syn, 0.02)
    assert (np.asarray(r1.e_hat) == np.asarray(r2.e_hat)).all()
    assert (np.asarray(r1.n_iter) == np.asarray(r2.n_iter)).all()
    assert (np.asarray(r1.converged) == np.asarray(r2.converged)).all()
    # Posterior parity on failed shots (feeds OSD).
    failed = ~np.asarray(r1.converged)
    if failed.any():
        assert np.allclose(np.asarray(r1.posterior)[failed],
                           np.asarray(r2.posterior)[failed])


def test_highp_guard_serial_equals_full():
    """The serial-schedule cascade's high-p guard (gated intermediate
    skip + full-depth catch-all windows, decoders/cascade.py) must be
    bit-identical to a plain full-depth decode when it fires (>2/3 of
    the batch failing stage 1) AND when it does not."""
    rng = np.random.default_rng(7)
    H = np.asarray(get_code("lp04_0").Hz)
    graph = TannerGraph.build(H)
    from qldpcsim_jax.decoders.common import build_layers

    layers = build_layers(H, "S")
    for p in (0.03, 0.30):     # guard idle / guard firing
        syn = _shots(rng, H, 192, p)
        single = make_decoder(graph, DecoderConfig(
            dec_type="MS", max_iter=30, round1_iters=-1,
            schedule="S"), layers=layers)
        casc = make_decoder(graph, DecoderConfig(
            dec_type="MS", max_iter=30, schedule="S"), layers=layers)
        r1 = single(syn, 0.02)
        r2 = casc(syn, 0.02)
        assert (np.asarray(r1.e_hat) == np.asarray(r2.e_hat)).all(), p
        assert (np.asarray(r1.n_iter) == np.asarray(r2.n_iter)).all(), p
        assert (np.asarray(r1.converged)
                == np.asarray(r2.converged)).all(), p
