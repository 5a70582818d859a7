"""Batched normalized min-sum decoder (reference: decoders.py:110-182).

Semantics parity with the reference, per SURVEY.md §3.3 / §2.7:
  * beta-normalized extrinsic check-node update with the (min, min2) rule;
    the min/min2 assignment uses VALUE equality (|msg| == min) like the
    reference's aliasing trick (decoders.py:162-168), so ties at the minimum
    all receive min2 (== min under a tie);
  * sign(0) treated as +1 (decoders.py:158);
  * syndrome sign folded into the check-node output (decoders.py:151,167);
  * layered scheduling: check-node update on the layer's rows only, then a
    GLOBAL variable-node update and per-layer early exit on syndrome match
    (decoders.py:154-177);
  * non-converged shots report n_iter = max_iter and the last posterior
    (consumed by OSD).

Design: messages live in a padded (B, m+1, dmax) edge layout (row m
is a dummy absorbing padded layer slots); the shot axis B is the batch axis,
iteration is a lax.while_loop with a per-shot convergence latch and all(done)
termination, and the per-layer early-exit syndrome check is a single
matmul.
"""

from __future__ import annotations

from functools import partial
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

_PRIOR_EPS = 1e-9  # reference: decoders.py:117 (L_ch denominator guard)


def make_ms_decoder(graph: TannerGraph, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None):
    """Build decode(syndromes, p) -> DecodeResult for min-sum over `graph`."""
    if layers is None:
        layers = build_layers(graph.H, cfg.schedule)

    m, n, dmax = graph.m, graph.n, graph.dmax
    f32 = jnp.float32
    # Static structure stays host-side NumPy: it is embedded as program
    # constants at trace time, so the factory never touches a device (and the
    # decoder works under any jax.default_device).
    layer_rows = np.asarray(layers.rows, dtype=np.int32)         # (L, maxL)
    n_layers = layers.n_layers
    row_vars = np.asarray(graph.row_vars, dtype=np.int32)        # (m+1, dmax)
    row_mask = np.asarray(graph.row_mask)                        # (m+1, dmax)
    var_rows = np.asarray(graph.var_rows, dtype=np.int32)        # (n, cmax)
    var_slots = np.asarray(graph.var_slots, dtype=np.int32)
    var_mask = np.asarray(graph.var_mask)
    H_T = np.asarray(graph.H.T, dtype=np.float32)                # (n, m)
    beta = f32(cfg.beta)
    max_iter = int(cfg.max_iter)
    iota_d = np.arange(dmax, dtype=np.int32)

    def _cn_vn_layer(l, state, syn_f, syn_sign_pad, L_ch, it):
        msg_v2c, msg_c2v, done, e_lat, it_lat, posterior = state
        rows = jnp.asarray(layer_rows)[l]                        # (maxL,)
        rmask = jnp.asarray(row_mask)[rows]                      # (maxL, dmax)

        # ---- check-node update on this layer's rows ----
        mv = msg_v2c[:, rows, :]                                 # (B, maxL, dmax)
        neg = jnp.where(rmask[None], (mv < 0).astype(jnp.int32), 0)
        sign = 1.0 - 2.0 * (mv < 0).astype(f32)                  # sign(0) = +1
        a = jnp.where(rmask[None], jnp.abs(mv), jnp.inf)
        min1 = jnp.min(a, axis=-1, keepdims=True)
        first_min = jnp.argmin(a, axis=-1)                       # first occurrence
        a2 = jnp.where(iota_d == first_min[..., None], jnp.inf, a)
        min2 = jnp.min(a2, axis=-1, keepdims=True)
        min1 = jnp.where(jnp.isinf(min1), 0.0, min1)
        min2 = jnp.where(jnp.isinf(min2), 0.0, min2)
        parity = jnp.sum(neg, axis=-1, keepdims=True) & 1
        prod_sign = 1.0 - 2.0 * parity.astype(f32)
        # Value-equality min/min2 selection (ties at the min all take min2).
        mag = jnp.where(jnp.abs(mv) == min1, min2, min1)
        new_c2v = beta * syn_sign_pad[:, rows, None] * prod_sign * sign * mag
        new_c2v = jnp.where(rmask[None], new_c2v, 0.0)
        msg_c2v = msg_c2v.at[:, rows, :].set(new_c2v)

        # ---- global variable-node update ----
        gathered = msg_c2v[:, var_rows, var_slots]               # (B, n, cmax)
        vnsum = jnp.sum(jnp.where(var_mask[None], gathered, 0.0), axis=-1)
        posterior = L_ch + vnsum                                 # (B, n)
        e_hat = posterior < 0.0

        # ---- per-layer early exit (latched per shot) ----
        syn_est = jnp.mod(jnp.dot(e_hat.astype(f32), H_T,
                                  preferred_element_type=f32), 2.0)
        ok = jnp.all(syn_est == syn_f, axis=-1)
        newly = ok & (~done)
        e_lat = jnp.where(newly[:, None], e_hat, e_lat)
        it_lat = jnp.where(newly, it + 1, it_lat)
        done = done | ok

        # ---- v2c refresh (global, uses freshest c2v) ----
        pos_r = posterior[:, jnp.minimum(row_vars, n - 1)]       # (B, m+1, dmax)
        msg_v2c = jnp.where(row_mask[None], pos_r - msg_c2v, 0.0)
        return msg_v2c, msg_c2v, done, e_lat, it_lat, posterior

    def decode(syndromes, p):
        """syndromes: (B, m) integer/bool; p: scalar prior error probability."""
        B = syndromes.shape[0]
        syn_f = jnp.asarray(syndromes).astype(f32)
        p = jnp.asarray(p, dtype=f32)
        L_ch = jnp.log((1.0 - p) / jnp.maximum(p, _PRIOR_EPS))
        syn_sign = jnp.where(syn_f == 1.0, f32(-1.0), f32(1.0))   # (B, m)
        syn_sign_pad = jnp.pad(syn_sign, ((0, 0), (0, 1)), constant_values=1.0)

        msg_v2c0 = jnp.where(row_mask[None], L_ch, 0.0) * jnp.ones((B, 1, 1), f32)
        msg_c2v0 = jnp.zeros((B, m + 1, dmax), f32)
        done0 = jnp.zeros((B,), bool)
        e_lat0 = jnp.zeros((B, n), bool)
        it_lat0 = jnp.full((B,), max_iter, jnp.int32)
        posterior0 = jnp.full((B, n), L_ch, f32)

        def cond(carry):
            it = carry[0]
            done = carry[4]
            return (it < max_iter) & (~jnp.all(done))

        def body(carry):
            it = carry[0]
            state = carry[1:]
            state = jax.lax.fori_loop(
                0, n_layers,
                lambda l, s: _cn_vn_layer(l, s, syn_f, syn_sign_pad, L_ch, it),
                tuple(state),
            )
            return (it + 1,) + tuple(state)

        carry = (jnp.int32(0), msg_v2c0, msg_c2v0, done0, e_lat0, it_lat0, posterior0)
        _, _, _, done, e_lat, it_lat, posterior = jax.lax.while_loop(cond, body, carry)

        e_last = posterior < 0.0
        e_hat = jnp.where(done[:, None], e_lat, e_last)
        return DecodeResult(
            e_hat=e_hat.astype(jnp.int8),
            n_iter=it_lat,
            converged=done,
            posterior=posterior,
        )

    return decode
