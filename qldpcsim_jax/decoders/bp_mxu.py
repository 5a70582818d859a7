"""Incidence-matmul sum-product BP decoder (`impl="mxu"`).

Same restructure as decoders/ms_mxu.py applied to the tanh-product BP of
decoders/bp.py (reference decoders.py:189-290): the global VN refresh
msg_v2c[e] = posterior[var] - msg_c2v[e] is idempotent, so v2c is materialized
lazily per layer from (posterior, c2v) via an incidence matmul, the check-node
tanh-product update is elementwise on the layer's edge block, and the
posterior update is incremental. Early-exit checks use an exact bf16 integer
matmul. Iteration counting and priors match the reference; floating-point
association differs from the edge path (statistical parity — DIVERGENCES.md).
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
from qldpcsim_jax.decoders.ms_mxu import _contiguous_ranges

_PRIOR_EPS = 1e-9
# Real-valued LLR dots: full f32, never TF32 (0/1-only dots stay default —
# integer counts below 2^24 are exact in any mode).
_HIGHEST = jax.lax.Precision.HIGHEST
_TANH_FLOOR = 1e-12


def make_bp_mxu_decoder(graph: TannerGraph, cfg: DecoderConfig,
                        layers: Optional[LayerSchedule] = None):
    if layers is None:
        layers = build_layers(graph.H, cfg.schedule)
    m, n, dmax = graph.m, graph.n, graph.dmax
    ranges = _contiguous_ranges(layers, m)
    assert ranges is not None, "mxu BP path requires contiguous layers"

    f32, bf16 = jnp.float32, jnp.bfloat16
    max_iter = int(cfg.max_iter)
    clamp = f32(1.0 - cfg.eps)

    A_T, A, masks = [], [], []
    for (s, e) in ranges:
        rv = graph.row_vars[s:e]
        rm = graph.row_mask[s:e]
        L = e - s
        Ai = np.zeros((L * dmax, n), dtype=np.float32)
        flat_rv = rv.reshape(-1)
        idx = np.nonzero(rm.reshape(-1))[0]
        Ai[idx, flat_rv[idx]] = 1.0
        # Host-side NumPy — embedded as program constants at trace time.
        A.append(Ai)
        A_T.append(np.ascontiguousarray(Ai.T))
        masks.append(np.asarray(rm))

    H_T_f = np.asarray(graph.H.T, dtype=np.float32)

    def decode(syndromes, p):
        B = syndromes.shape[0]
        syn_f = jnp.asarray(syndromes).astype(f32)
        p = jnp.asarray(p, dtype=f32)
        L0 = jnp.log((1.0 - p) / jnp.maximum(p, _PRIOR_EPS))

        def one_layer(li, c2v, posterior, state, it):
            done, e_lat, it_lat = state
            s, e = ranges[li]
            L = e - s
            rmask = masks[li]
            c2v_l = c2v[:, s:e]
            pos_r = jnp.dot(posterior, A_T[li], precision=_HIGHEST,
                            preferred_element_type=f32).reshape(B, L, dmax)
            mv = jnp.where(rmask[None], pos_r - c2v_l, 0.0)

            t = jnp.tanh(mv * 0.5)
            t = jnp.where(rmask[None], t, 1.0)
            t_sgn = jnp.where(t < 0, -1.0, 1.0)
            t = t_sgn * jnp.maximum(jnp.abs(t), _TANH_FLOOR)
            prod = jnp.prod(t, axis=-1, keepdims=True)
            th2 = jnp.clip(prod / t, -clamp, clamp)
            val = 2.0 * jnp.arctanh(th2)
            syn_l = syn_f[:, s:e]
            val = jnp.where(syn_l[..., None] == 1.0, -val, val)
            new_c2v = jnp.where(rmask[None], val, 0.0)

            delta = (new_c2v - c2v_l).reshape(B, L * dmax)
            posterior = posterior + jnp.dot(delta, A[li], precision=_HIGHEST,
                                            preferred_element_type=f32)
            c2v = jax.lax.dynamic_update_slice(c2v, new_c2v, (0, s, 0))

            e_hat = posterior < 0.0
            syn_est = jnp.mod(jnp.dot(e_hat.astype(bf16), jnp.asarray(H_T_f, bf16),
                                      preferred_element_type=f32), 2.0)
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
            jnp.full((B, n), L0, f32),
            jnp.zeros((B,), bool),
            jnp.zeros((B, n), bool),
            jnp.full((B,), max_iter, jnp.int32),
        )
        _, _, posterior, done, e_lat, it_lat = jax.lax.while_loop(cond, body, carry)
        e_hat = jnp.where(done[:, None], e_lat, posterior < 0.0)
        return DecodeResult(e_hat=e_hat.astype(jnp.int8), n_iter=it_lat,
                            converged=done, posterior=posterior)

    return decode
