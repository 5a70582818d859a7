"""Triton QC min-sum kernel (interpret mode on CPU) vs the bit-exact edge
path: identical message math, state in global scratch and an incremental
posterior — decisions agree except on numerical ties (same class as the mxu
tests). The kernel needs a power-of-two lift size; besides LP118 (L=16) the
tests use a small random circulant-lifted matrix with L=8."""

import numpy as np
import pytest

from qldpcsim_jax.codes import get_code
from qldpcsim_jax.decoders import DecoderConfig, TannerGraph, build_layers
from qldpcsim_jax.decoders.ms import make_ms_decoder
from qldpcsim_jax.ops.qc import detect_qc, layers_align_blocks
from qldpcsim_jax.ops.ms_qc_triton import make_ms_qc_decoder, supports


def _lifted(L=8, m_b=3, n_b=8, seed=5):
    """Random circulant-lifted H with every base entry present."""
    r = np.random.default_rng(seed)
    shifts = r.integers(0, L, size=(m_b, n_b))
    H = np.zeros((m_b * L, n_b * L), np.int8)
    base = np.arange(L)
    for i in range(m_b):
        for j in range(n_b):
            H[i * L + base, j * L + (base + shifts[i, j]) % L] = 1
    return H


def _H(name):
    return _lifted() if name == "lifted8" else np.asarray(get_code(name).Hz)


def _syn(rng, H, n_shots, p):
    n = H.shape[1]
    errs = (rng.random((n_shots, n)) < p).astype(np.int8)
    return ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)


def _qc(H, cfg, layers, **kw):
    return make_ms_qc_decoder(detect_qc(H), cfg, layers=layers,
                              block_shots=16, interpret=True, **kw)


def test_detect_qc_library_codes():
    assert detect_qc(np.asarray(get_code("lp118_0").Hx)).L == 16
    assert detect_qc(np.asarray(get_code("lp04_0").Hx)).L == 7
    assert detect_qc(np.asarray(get_code("tanner").Hx)).L == 31
    # bicycle is circulant but not permutation-lifted; shor is not QC
    assert detect_qc(np.asarray(get_code("bicycle").Hx)) is None
    assert detect_qc(np.asarray(get_code("shor").Hx)) is None


def test_layers_align():
    H = np.asarray(get_code("lp118_0").Hz)
    st = detect_qc(H)
    layers = build_layers(H, "L")
    assert layers_align_blocks(layers, st)


@pytest.mark.parametrize("codename,schedule", [
    ("lifted8", "F"), ("lifted8", "L"), ("lp118_0", "L"),
])
def test_qc_kernel_agrees_with_edge(codename, schedule):
    rng = np.random.default_rng(21)
    H = _H(codename)
    assert detect_qc(H) is not None
    graph = TannerGraph.build(H)
    layers = build_layers(H, schedule)
    cfg = DecoderConfig(dec_type="MS", max_iter=8, schedule=schedule)
    edge = make_ms_decoder(graph, cfg, layers=layers)
    qc = _qc(H, cfg, layers)
    syn = _syn(rng, H, 32, 0.03)
    re, rq = edge(syn, 0.015), qc(syn, 0.015)
    conv_e, conv_q = np.asarray(re.converged), np.asarray(rq.converged)
    same = conv_e == conv_q
    assert same.mean() >= 0.95, f"convergence agreement {same.mean():.2%}"
    both = conv_e & conv_q
    if both.any():
        agree = (np.asarray(re.e_hat)[both] == np.asarray(rq.e_hat)[both]).all(axis=1)
        assert agree.mean() >= 0.95
        it_same = np.asarray(re.n_iter)[both] == np.asarray(rq.n_iter)[both]
        assert it_same.mean() >= 0.9


def test_qc_kernel_zero_syndrome():
    H = _H("lifted8")
    cfg = DecoderConfig(dec_type="MS", max_iter=5, schedule="L")
    qc = _qc(H, cfg, build_layers(H, "L"))
    r = qc(np.zeros((8, H.shape[0]), np.int8), 0.01)
    assert np.asarray(r.converged).all()
    assert (np.asarray(r.n_iter) == 1).all()
    assert (np.asarray(r.e_hat) == 0).all()


def test_qc_kernel_syndrome_consistency():
    rng = np.random.default_rng(22)
    H = _H("lifted8")
    cfg = DecoderConfig(dec_type="MS", max_iter=12, schedule="L")
    qc = _qc(H, cfg, build_layers(H, "L"))
    syn = _syn(rng, H, 16, 0.02)
    r = qc(syn, 0.01)
    conv = np.asarray(r.converged)
    assert conv.any()
    e = np.asarray(r.e_hat).astype(np.int64)
    assert ((e @ H.T.astype(np.int64)) % 2 == np.asarray(syn))[conv].all()


def test_qc_kernel_check_granularity():
    """The kernel checks convergence once per iteration, the edge path after
    every layer: a shot the kernel reports converged at iteration k matched
    at the latest on the last layer of k, so its count is never below the
    edge path's, and equal unless a later layer broke a mid-iteration
    match."""
    rng = np.random.default_rng(23)
    H = _H("lifted8")
    layers = build_layers(H, "L")
    cfg = DecoderConfig(dec_type="MS", max_iter=10, schedule="L")
    syn = _syn(rng, H, 32, 0.03)
    re = make_ms_decoder(TannerGraph.build(H), cfg, layers=layers)(syn, 0.015)
    rq = _qc(H, cfg, layers)(syn, 0.015)
    both = np.asarray(re.converged) & np.asarray(rq.converged)
    assert both.any()
    it_e, it_q = np.asarray(re.n_iter)[both], np.asarray(rq.n_iter)[both]
    assert (it_q >= it_e).all()
    assert (it_q == it_e).mean() >= 0.9


def test_qc_kernel_pads_partial_batch():
    """A batch that is not a multiple of the shot tile is padded with zero
    syndromes; each shot decodes exactly as it would in a full tile."""
    rng = np.random.default_rng(24)
    H = _H("lifted8")
    layers = build_layers(H, "L")
    cfg = DecoderConfig(dec_type="MS", max_iter=8, schedule="L")
    qc = _qc(H, cfg, layers)
    syn = _syn(rng, H, 32, 0.03)
    full, part = qc(syn, 0.015), qc(syn[:21], 0.015)
    assert part.e_hat.shape == (21, H.shape[1])
    assert part.posterior.shape == (21, H.shape[1])
    for k in ("e_hat", "n_iter", "converged", "posterior"):
        assert (np.asarray(getattr(part, k))
                == np.asarray(getattr(full, k))[:21]).all(), k


@pytest.mark.parametrize("schedule", ["L", "F"])
def test_qc_kernel_lowers_for_cuda(schedule):
    """Every primitive of the kernel at the flagship's widths (LP118_0,
    B=4096, 50 iterations) has a Triton lowering rule: the program lowers
    for CUDA here, with no card (compiling the Triton IR needs one)."""
    import jax
    import jax.numpy as jnp
    from jax import export

    H = np.asarray(get_code("lp118_0").Hz)
    cfg = DecoderConfig(dec_type="MS", max_iter=50, schedule=schedule)
    dec = make_ms_qc_decoder(detect_qc(H), cfg,
                             layers=build_layers(H, schedule))
    exp = export.export(
        jax.jit(dec), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        jax.ShapeDtypeStruct((4096, H.shape[0]), jnp.int8),
        jax.ShapeDtypeStruct((), jnp.float32))
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.parametrize("codename,dec,schedule,ok", [
    ("lp118_0", "MS", "L", True),     # L = 16
    ("lp118_0", "MS", "F", True),
    ("lp118_0", "MS", "S", False),    # serial: decoders/sequential.py
    ("lp118_0", "BP", "L", False),    # MS only
    ("lp04_0", "MS", "L", False),     # L = 7: not a power of two
    ("tanner", "MS", "L", False),     # L = 31
    ("steane", "MS", "L", False),     # not circulant-lifted
])
def test_qc_kernel_supports(codename, dec, schedule, ok):
    H = np.asarray(get_code(codename).Hz)
    cfg = DecoderConfig(dec_type=dec, schedule=schedule)
    assert supports(detect_qc(H), cfg, build_layers(H, schedule)) == ok
