"""Batched syndrome decoders over Tanner graphs.

Decoder families (reference: qLDPCsim/decoders.py):
  * NG  — naive-greedy           (decoders.py:27-66)
  * BF  — bit-flipping           (decoders.py:74-102)
  * MS  — normalized min-sum     (decoders.py:110-182)
  * BP  — belief propagation     (decoders.py:189-290)
  * OSD — ordered-statistics post-decoder (decoders.py:299-369)

All decoders here are batched over shots (the reference decodes one shot per
Python call), run under jit with static shapes, and use a padded edge layout
(row-major (m, dmax) message blocks) instead of the reference's dense (m, n)
matrices or per-edge Python loops.
"""

from qldpcsim_jax.decoders.common import (
    TannerGraph,
    LayerSchedule,
    layerize,
    build_layers,
    DecoderConfig,
    DecodeResult,
)
from qldpcsim_jax.decoders.ms import make_ms_decoder
from qldpcsim_jax.decoders.bp import make_bp_decoder
from qldpcsim_jax.decoders.bf import make_bf_decoder
from qldpcsim_jax.decoders.ng import make_ng_decoder
from qldpcsim_jax.decoders.osd import make_osd, OSDStatic

__all__ = [
    "TannerGraph",
    "LayerSchedule",
    "layerize",
    "build_layers",
    "DecoderConfig",
    "DecodeResult",
    "make_ms_decoder",
    "make_bp_decoder",
    "make_bf_decoder",
    "make_ng_decoder",
    "make_osd",
    "OSDStatic",
    "make_decoder",
]


def _qc_factory(graph, cfg, eff_layers):
    """Triton QC min-sum kernel factory (ops/ms_qc_triton.py), or None when
    the platform decision (platform.qc_kernel_applies) does not pick it."""
    from qldpcsim_jax.ops import ms_qc_triton
    from qldpcsim_jax.ops.qc import detect_qc
    from qldpcsim_jax.platform import qc_kernel_applies, resolve_platform

    st = detect_qc(graph.H)
    if not qc_kernel_applies(resolve_platform(cfg.platform), cfg.impl,
                             ms_qc_triton.supports(st, cfg, eff_layers)):
        return None

    def factory(graph2, cfg2, layers=None):
        return ms_qc_triton.make_ms_qc_decoder(st, cfg2, layers=layers)

    return factory


def make_decoder(graph, cfg, layers=None):
    """Dispatch a batched decoder for `cfg.dec_type` over `graph`.

    Mirrors the reference's decoder dispatch (simulator.py:270-284) but
    returns a jit-compatible batched callable
    decode(syndromes, p) -> DecodeResult. Iterative decoders (MS/BP) get
    two-round straggler compaction when the iteration budget is deep
    (see decoders/cascade.py).
    """
    from qldpcsim_jax.decoders.cascade import make_cascade, make_tworound
    from qldpcsim_jax.decoders.ms_mxu import make_ms_mxu_decoder, supports as mxu_supports
    from qldpcsim_jax.decoders.common import build_layers as _bl

    if graph.m == 0:
        # No checks (a one-sided CSS code): the zero error is the answer.
        # Decode through one inert zero row so every family keeps
        # non-empty static shapes.
        import jax.numpy as jnp
        import numpy as np

        inner = make_decoder(
            TannerGraph.build(np.zeros((1, graph.n), graph.H.dtype)), cfg)

        def decode_no_checks(syndromes, p):
            return inner(jnp.zeros((syndromes.shape[0], 1), jnp.int8), p)

        return decode_no_checks

    kind = cfg.dec_type.upper()
    if kind in ("MS", "BP"):
        factory = make_ms_decoder if kind == "MS" else make_bp_decoder
        if cfg.impl not in ("auto", "edge", "mxu", "seq", "qc"):
            raise ValueError(f"unknown decoder impl {cfg.impl!r}")
        if cfg.impl != "edge":
            from qldpcsim_jax.decoders.bp_mxu import make_bp_mxu_decoder
            from qldpcsim_jax.decoders import sequential as _seq

            eff_layers = layers if layers is not None else _bl(graph.H, cfg.schedule)
            qc_factory = (_qc_factory(graph, cfg, eff_layers)
                          if kind == "MS" else None)
            if cfg.impl == "qc" and qc_factory is None:
                raise ValueError("qc kernel supports MS decoding only")
            if qc_factory is not None:
                factory = qc_factory
                layers = eff_layers
            # Row-sequential path for serial schedules (1-row layers): the
            # incremental-syndrome formulation beats both edge and mxu once
            # there are many layers.
            elif _seq.supports(eff_layers) and (
                    cfg.impl == "seq" or eff_layers.n_layers > 8):
                factory = (_seq.make_ms_seq_decoder if kind == "MS"
                           else _seq.make_bp_seq_decoder)
                layers = eff_layers
            elif mxu_supports(graph, eff_layers):
                factory = make_ms_mxu_decoder if kind == "MS" else make_bp_mxu_decoder
                layers = eff_layers
            elif cfg.impl == "mxu":
                raise ValueError("mxu path requires contiguous layers "
                                 f"and <=48 of them (got {eff_layers.n_layers})")
            elif cfg.impl == "seq":
                raise ValueError("seq path requires a serial (1-row-layer) "
                                 "schedule")
        r1 = cfg.round1_iters
        if r1 < 0 or cfg.max_iter <= 12:
            return factory(graph, cfg, layers=layers)
        if r1 > 0:
            return make_tworound(factory, graph, cfg, layers, r1,
                                 cfg.compact_cap_frac)
        return make_cascade(factory, graph, cfg, layers)
    if kind == "BF":
        return make_bf_decoder(graph, cfg)
    if kind == "NG":
        return make_ng_decoder(graph, cfg)
    raise ValueError("Unrecognized decoder type.")
