"""Incidence-matmul normalized min-sum decoder (`impl="mxu"`).

Same message-passing math as decoders/ms.py (reference decoders.py:110-182)
restructured around incidence matmuls instead of gathers and scatters, and
around the fact that the reference's global variable-node refresh is
IDEMPOTENT — msg_v2c[r] = posterior - msg_c2v[r]
depends only on current state, so v2c never needs materializing. The decoder
state shrinks to (msg_c2v, posterior), and per layer:

    v2c_l      = posterior·A_lᵀ - c2v_l          (incidence matmul, f32 HIGHEST)
    new_c2v_l  = beta-normalized min-sum CN update (elementwise)
    posterior += (new_c2v_l - c2v_l)·A_l          (incidence matmul, f32 HIGHEST)
    e_hat      = posterior < 0 ; early-exit check = e_hat·Hᵀ in bf16
                 (0/1 inputs, row sums < 256 ⇒ bf16 matmul is EXACT)

Layers from the greedy contiguous layerizer are static row ranges, so layer
work is static slicing — no ragged gathers. The posterior update is
incremental (+= delta) rather than the reference's full re-sum, which changes
only floating-point association: decisions can differ on measure-zero ties, so
qBLER parity is statistical (MC-bounds), not bit-exact — the edge-layout
implementation (decoders/ms.py) remains the bit-exact-parity path and test
oracle (see DIVERGENCES.md). Iteration counting, early-exit granularity and
all priors match the reference exactly.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qldpcsim_jax.decoders.common import (
    DecodeResult,
    DecoderConfig,
    LayerSchedule,
    TannerGraph,
    build_layers,
)

_PRIOR_EPS = 1e-9
# Real-valued LLR dots: full f32, never TF32 (0/1-only dots stay default —
# integer counts below 2^24 are exact in any mode).
_HIGHEST = jax.lax.Precision.HIGHEST


def _contiguous_ranges(layers: LayerSchedule, m: int):
    """Recover static (start, end) ranges from the padded layer arrays.
    The greedy layerizer emits contiguous ranges (simulator.py:212-224)."""
    ranges = []
    for li in range(layers.n_layers):
        size = int(layers.sizes[li])
        rows = layers.rows[li, :size]
        if size == 0:
            continue
        s, e = int(rows[0]), int(rows[-1]) + 1
        if not (rows == np.arange(s, e)).all():
            return None  # non-contiguous (cross-wired compat mode) — bail
        ranges.append((s, e))
    if not ranges:
        return None
    return ranges


def supports(graph: TannerGraph, layers: Optional[LayerSchedule],
             max_layers: int = 48) -> bool:
    """The incidence-matmul path applies when layers are contiguous and few
    (they are unrolled)."""
    if layers is None:
        return True  # flooding
    if layers.n_layers > max_layers:
        return False
    return _contiguous_ranges(layers, graph.m) is not None


def make_ms_mxu_decoder(graph: TannerGraph, cfg: DecoderConfig,
                        layers: Optional[LayerSchedule] = None):
    if layers is None:
        layers = build_layers(graph.H, cfg.schedule)
    m, n, dmax = graph.m, graph.n, graph.dmax
    ranges = _contiguous_ranges(layers, m)
    assert ranges is not None, "mxu MS path requires contiguous layers"

    f32, bf16 = jnp.float32, jnp.bfloat16
    beta = f32(cfg.beta)
    max_iter = int(cfg.max_iter)

    # Per-layer constants: incidence A_l ((e-s)*dmax, n) and slot masks.
    # Host-side NumPy — embedded as program constants at trace time, so the
    # factory never touches a device.
    A_T = []          # (n, E_l) f32 — maps posterior -> layer edge slots
    A = []            # (E_l, n) f32 — maps edge deltas -> variables
    masks = []        # (e-s, dmax) bool
    for (s, e) in ranges:
        rv = graph.row_vars[s:e]          # (L, dmax), pad value n
        rm = graph.row_mask[s:e]
        L = e - s
        Ai = np.zeros((L * dmax, n), dtype=np.float32)
        flat_rv = rv.reshape(-1)
        flat_rm = rm.reshape(-1)
        idx = np.nonzero(flat_rm)[0]
        Ai[idx, flat_rv[idx]] = 1.0
        A.append(Ai)
        A_T.append(np.ascontiguousarray(Ai.T))
        masks.append(np.asarray(rm))

    H_T_f = np.asarray(graph.H.T, dtype=np.float32)  # cast to bf16 at trace
    iota_d = np.arange(dmax, dtype=np.int32)

    def decode(syndromes, p):
        B = syndromes.shape[0]
        syn_f = jnp.asarray(syndromes).astype(f32)                 # (B, m)
        p = jnp.asarray(p, dtype=f32)
        L_ch = jnp.log((1.0 - p) / jnp.maximum(p, _PRIOR_EPS))
        syn_sign = jnp.where(syn_f == 1.0, f32(-1.0), f32(1.0))

        def one_layer(li, c2v, posterior, state, it):
            done, e_lat, it_lat = state
            s, e = ranges[li]
            L = e - s
            rmask = masks[li]
            c2v_l = c2v[:, s:e]                                   # (B, L, dmax)
            pos_r = jnp.dot(posterior, A_T[li], precision=_HIGHEST,
                            preferred_element_type=f32).reshape(B, L, dmax)
            mv = jnp.where(rmask[None], pos_r - c2v_l, 0.0)

            # ---- check-node min-sum update (value-equality min/min2) ----
            sign = 1.0 - 2.0 * (mv < 0).astype(f32)
            a = jnp.where(rmask[None], jnp.abs(mv), jnp.inf)
            min1 = jnp.min(a, axis=-1, keepdims=True)
            first_min = jnp.argmin(a, axis=-1)
            a2 = jnp.where(iota_d == first_min[..., None], jnp.inf, a)
            min2 = jnp.min(a2, axis=-1, keepdims=True)
            min1 = jnp.where(jnp.isinf(min1), 0.0, min1)
            min2 = jnp.where(jnp.isinf(min2), 0.0, min2)
            parity = jnp.sum(jnp.where(rmask[None], (mv < 0), False),
                             axis=-1, keepdims=True)
            prod_sign = 1.0 - 2.0 * (parity & 1).astype(f32)
            mag = jnp.where(jnp.abs(mv) == min1, min2, min1)
            new_c2v = beta * syn_sign[:, s:e, None] * prod_sign * sign * mag
            new_c2v = jnp.where(rmask[None], new_c2v, 0.0)

            # ---- incremental posterior + state writeback ----
            delta = (new_c2v - c2v_l).reshape(B, L * dmax)
            posterior = posterior + jnp.dot(delta, A[li], precision=_HIGHEST,
                                            preferred_element_type=f32)
            c2v = jax.lax.dynamic_update_slice(c2v, new_c2v, (0, s, 0))

            # ---- per-layer early exit (exact bf16 integer matmul) ----
            e_hat = posterior < 0.0
            syn_est = jnp.dot(e_hat.astype(bf16), jnp.asarray(H_T_f, bf16),
                              preferred_element_type=f32)
            syn_est = jnp.mod(syn_est, 2.0)
            ok = jnp.all(syn_est == syn_f, axis=-1)
            newly = ok & (~done)
            e_lat = jnp.where(newly[:, None], e_hat, e_lat)
            it_lat = jnp.where(newly, it + 1, it_lat)
            done = done | ok
            return c2v, posterior, (done, e_lat, it_lat)

        def body(carry):
            it, c2v, posterior, done, e_lat, it_lat = carry
            state = (done, e_lat, it_lat)
            for li in range(len(ranges)):
                c2v, posterior, state = one_layer(li, c2v, posterior, state, it)
            done, e_lat, it_lat = state
            return (it + 1, c2v, posterior, done, e_lat, it_lat)

        def cond(carry):
            return (carry[0] < max_iter) & (~jnp.all(carry[3]))

        carry = (
            jnp.int32(0),
            jnp.zeros((B, m, dmax), f32),
            jnp.full((B, n), L_ch, f32),
            jnp.zeros((B,), bool),
            jnp.zeros((B, n), bool),
            jnp.full((B,), max_iter, jnp.int32),
        )
        _, _, posterior, done, e_lat, it_lat = jax.lax.while_loop(cond, body, carry)
        e_hat = jnp.where(done[:, None], e_lat, posterior < 0.0)
        return DecodeResult(e_hat=e_hat.astype(jnp.int8), n_iter=it_lat,
                            converged=done, posterior=posterior)

    return decode
