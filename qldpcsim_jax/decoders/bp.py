"""Batched belief-propagation (sum-product) decoder
(reference: decoders.py:189-290).

Semantics parity: tanh-product check-node update with the syndrome sign flip
(decoders.py:249-262), global variable-node update and per-layer early exit
(decoders.py:264-285), layered scheduling over check subsets, n_iter = max_iter
for non-converged shots, and a posterior LLR output consumed by OSD
(decoders.py:287-288 — note the reference engine never wires OSD into BP,
landmine L5; this framework does, as BASELINE config 5 requires).

Design notes: the reference iterates per-edge Python loops over a
COO edge list (decoders.py:224-278) in float64; here the same message algebra
runs in float32 over the padded (B, m+1, dmax) edge layout with vectorized
products, a value clamp of the tanh quotient suited to f32 (cfg.eps, default
1e-6 vs the reference's 1e-9-in-f64 — see DIVERGENCES.md), and a
lax.while_loop convergence latch.
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

_PRIOR_EPS = 1e-9   # L0 guard (decoders.py:232 uses max(p, eps))
_TANH_FLOOR = 1e-12  # |tanh| floor to keep the extrinsic quotient finite


def make_bp_decoder(graph: TannerGraph, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None):
    """Build decode(syndromes, p) -> DecodeResult for sum-product BP."""
    if layers is None:
        layers = build_layers(graph.H, cfg.schedule)

    m, n, dmax = graph.m, graph.n, graph.dmax
    f32 = jnp.float32
    # Host-side NumPy — embedded as program constants at trace time, so the
    # factory never touches a device.
    layer_rows = np.asarray(layers.rows, dtype=np.int32)
    n_layers = layers.n_layers
    row_vars = np.asarray(graph.row_vars, dtype=np.int32)
    row_mask = np.asarray(graph.row_mask)
    var_rows = np.asarray(graph.var_rows, dtype=np.int32)
    var_slots = np.asarray(graph.var_slots, dtype=np.int32)
    var_mask = np.asarray(graph.var_mask)
    H_T = np.asarray(graph.H.T, dtype=np.float32)
    max_iter = int(cfg.max_iter)
    clamp = f32(1.0 - cfg.eps)

    def _layer(l, state, syn_f, L0, it):
        msg_v2c, msg_c2v, done, e_lat, it_lat, posterior = state
        rows = jnp.asarray(layer_rows)[l]
        rmask = jnp.asarray(row_mask)[rows]

        # ---- check-node update (tanh product, extrinsic) ----
        mv = msg_v2c[:, rows, :]
        t = jnp.tanh(mv * 0.5)
        t = jnp.where(rmask[None], t, 1.0)
        # Floor |t| so prod/t stays finite when a message is exactly 0.
        t_sgn = jnp.where(t < 0, -1.0, 1.0)
        t = t_sgn * jnp.maximum(jnp.abs(t), _TANH_FLOOR)
        prod = jnp.prod(t, axis=-1, keepdims=True)
        th2 = jnp.clip(prod / t, -clamp, clamp)
        val = 2.0 * jnp.arctanh(th2)
        syn_rows = syn_f[:, jnp.minimum(rows, syn_f.shape[1] - 1)]  # (B, maxL)
        val = jnp.where(syn_rows[..., None] == 1.0, -val, val)
        new_c2v = jnp.where(rmask[None], val, 0.0)
        msg_c2v = msg_c2v.at[:, rows, :].set(new_c2v)

        # ---- global variable-node update ----
        gathered = msg_c2v[:, var_rows, var_slots]
        vnsum = jnp.sum(jnp.where(var_mask[None], gathered, 0.0), axis=-1)
        posterior = L0 + vnsum
        e_hat = posterior < 0.0

        syn_est = jnp.mod(jnp.dot(e_hat.astype(f32), H_T,
                                  preferred_element_type=f32), 2.0)
        ok = jnp.all(syn_est == syn_f, axis=-1)
        newly = ok & (~done)
        e_lat = jnp.where(newly[:, None], e_hat, e_lat)
        it_lat = jnp.where(newly, it + 1, it_lat)
        done = done | ok

        pos_r = posterior[:, jnp.minimum(row_vars, n - 1)]
        msg_v2c = jnp.where(row_mask[None], pos_r - msg_c2v, 0.0)
        return msg_v2c, msg_c2v, done, e_lat, it_lat, posterior

    def decode(syndromes, p):
        B = syndromes.shape[0]
        syn_f = jnp.asarray(syndromes).astype(f32)
        p = jnp.asarray(p, dtype=f32)
        L0 = jnp.log((1.0 - p) / jnp.maximum(p, _PRIOR_EPS))

        msg_v2c0 = jnp.where(row_mask[None], L0, 0.0) * jnp.ones((B, 1, 1), f32)
        msg_c2v0 = jnp.zeros((B, m + 1, dmax), f32)
        carry = (
            jnp.int32(0),
            msg_v2c0,
            msg_c2v0,
            jnp.zeros((B,), bool),
            jnp.zeros((B, n), bool),
            jnp.full((B,), max_iter, jnp.int32),
            jnp.full((B, n), L0, f32),
        )

        def cond(c):
            return (c[0] < max_iter) & (~jnp.all(c[3]))

        def body(c):
            it = c[0]
            state = jax.lax.fori_loop(
                0, n_layers, lambda l, s: _layer(l, s, syn_f, L0, it), tuple(c[1:])
            )
            return (it + 1,) + tuple(state)

        _, _, _, done, e_lat, it_lat, posterior = jax.lax.while_loop(cond, body, carry)
        e_hat = jnp.where(done[:, None], e_lat, posterior < 0.0)
        return DecodeResult(
            e_hat=e_hat.astype(jnp.int8),
            n_iter=it_lat,
            converged=done,
            posterior=posterior,
        )

    return decode
