"""Row-sequential serial-schedule decoders vs the bit-exact edge path:
identical message math, incremental posterior/syndrome maintenance —
decisions must agree except on numerical ties (same class as the mxu tests).
"""

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import DecoderConfig, TannerGraph, build_layers, make_decoder
from qldpcsim_jax.decoders.ms import make_ms_decoder
from qldpcsim_jax.decoders.bp import make_bp_decoder
from qldpcsim_jax.decoders import sequential as seq


def _syn(rng, H, n_shots, p):
    n = H.shape[1]
    errs = (rng.random((n_shots, n)) < p).astype(np.int8)
    return ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)


@pytest.mark.parametrize("codename,kind", [
    ("steane", "MS"), ("bicycle", "MS"), ("lp04_0", "MS"),
    ("steane", "BP"), ("lp04_0", "BP"),
])
def test_seq_agrees_with_edge_serial(codename, kind):
    rng = np.random.default_rng(11)
    H = np.asarray(get_code(codename).Hz)
    graph = TannerGraph.build(H)
    layers = build_layers(H, "S")
    assert seq.supports(layers)
    cfg = DecoderConfig(dec_type=kind, max_iter=10, schedule="S")
    edge = (make_ms_decoder if kind == "MS" else make_bp_decoder)(
        graph, cfg, layers=layers)
    fast = seq.make_seq_decoder(graph, cfg, layers=layers, kind=kind)
    syn = _syn(rng, H, 48, 0.04)
    re, rf = edge(syn, 0.02), fast(syn, 0.02)
    conv_e, conv_f = np.asarray(re.converged), np.asarray(rf.converged)
    same = conv_e == conv_f
    assert same.mean() >= 0.95, f"convergence agreement {same.mean():.2%}"
    both = conv_e & conv_f
    if both.any():
        agree = (np.asarray(re.e_hat)[both] == np.asarray(rf.e_hat)[both]).all(axis=1)
        assert agree.mean() >= 0.95
        it_same = np.asarray(re.n_iter)[both] == np.asarray(rf.n_iter)[both]
        assert it_same.mean() >= 0.9


def test_seq_syndrome_consistency():
    """Converged outputs must satisfy H e = s exactly (the incremental
    syndrome bookkeeping must be exact integer XOR)."""
    rng = np.random.default_rng(12)
    H = np.asarray(get_code("tanner").Hz)
    graph = TannerGraph.build(H)
    layers = build_layers(H, "S")
    cfg = DecoderConfig(dec_type="MS", max_iter=6, schedule="S")
    fast = seq.make_seq_decoder(graph, cfg, layers=layers, kind="MS")
    syn = _syn(rng, H, 16, 0.02)
    r = fast(syn, 0.01)
    conv = np.asarray(r.converged)
    e = np.asarray(r.e_hat).astype(np.int64)
    syn_hat = (e @ H.T.astype(np.int64)) % 2
    assert (syn_hat[conv] == np.asarray(syn)[conv]).all()
    assert conv.any()


def test_dispatch_selects_seq_for_serial():
    H = np.asarray(get_code("tanner").Hz)
    graph = TannerGraph.build(H)
    cfg = DecoderConfig(dec_type="MS", max_iter=5, schedule="S", impl="seq")
    dec = make_decoder(graph, cfg)   # must not raise
    syn = np.zeros((4, H.shape[0]), np.int8)
    r = dec(syn, 0.01)
    assert np.asarray(r.converged).all()
    assert (np.asarray(r.n_iter) == 1).all()
