"""MXU-formulated MS vs the bit-exact edge-layout MS: identical message math,
different fp association — decisions must agree except on numerical ties."""

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import DecoderConfig, TannerGraph, build_layers
from qldpcsim_jax.decoders.ms import make_ms_decoder
from qldpcsim_jax.decoders.ms_mxu import make_ms_mxu_decoder, supports


def _syn(rng, H, n_shots, p):
    n = H.shape[1]
    errs = (rng.random((n_shots, n)) < p).astype(np.int8)
    return ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)


@pytest.mark.parametrize("codename,schedule", [
    ("steane", "F"), ("lp04_0", "F"), ("lp04_0", "L"), ("lp118_0", "L"),
])
def test_mxu_agrees_with_edge(codename, schedule):
    rng = np.random.default_rng(5)
    H = np.asarray(get_code(codename).Hz)
    graph = TannerGraph.build(H)
    layers = build_layers(H, schedule)
    assert supports(graph, layers)
    cfg = DecoderConfig(dec_type="MS", max_iter=15, schedule=schedule)
    edge = make_ms_decoder(graph, cfg, layers=layers)
    mxu = make_ms_mxu_decoder(graph, cfg, layers=layers)
    syn = _syn(rng, H, 64, 0.04)
    re = edge(syn, 0.02)
    rm = mxu(syn, 0.02)
    conv_e = np.asarray(re.converged)
    conv_m = np.asarray(rm.converged)
    same = conv_e == conv_m
    # fp association differences may flip rare ties; demand near-total agreement
    assert same.mean() >= 0.97, f"convergence agreement {same.mean():.2%}"
    both = conv_e & conv_m
    e_agree = (np.asarray(re.e_hat)[both] == np.asarray(rm.e_hat)[both]).all(axis=1)
    assert e_agree.mean() >= 0.97
    it_same = (np.asarray(re.n_iter)[both] == np.asarray(rm.n_iter)[both])
    assert it_same.mean() >= 0.95


def test_mxu_rejects_serial_big():
    H = np.asarray(get_code("tanner").Hz)
    graph = TannerGraph.build(H)
    layers = build_layers(H, "S")
    assert not supports(graph, layers)


@pytest.mark.parametrize("codename,schedule", [("steane", "F"), ("lp04_0", "L")])
def test_bp_mxu_agrees_with_edge(codename, schedule):
    from qldpcsim_jax.decoders.bp import make_bp_decoder
    from qldpcsim_jax.decoders.bp_mxu import make_bp_mxu_decoder

    rng = np.random.default_rng(6)
    H = np.asarray(get_code(codename).Hz)
    graph = TannerGraph.build(H)
    layers = build_layers(H, schedule)
    cfg = DecoderConfig(dec_type="BP", max_iter=12, schedule=schedule)
    edge = make_bp_decoder(graph, cfg, layers=layers)
    mxu = make_bp_mxu_decoder(graph, cfg, layers=layers)
    syn = _syn(rng, H, 64, 0.04)
    re, rm = edge(syn, 0.02), mxu(syn, 0.02)
    same = np.asarray(re.converged) == np.asarray(rm.converged)
    assert same.mean() >= 0.95
    both = np.asarray(re.converged) & np.asarray(rm.converged)
    agree = (np.asarray(re.e_hat)[both] == np.asarray(rm.e_hat)[both]).all(axis=1)
    assert agree.mean() >= 0.95
