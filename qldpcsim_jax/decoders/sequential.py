"""Row-sequential MS/BP decoders for serial (and long layered) schedules.

The reference's serial schedule (decSchedule='S', simulator.py:218) updates
one check row per layer with a GLOBAL variable-node refresh and a per-layer
convergence test (decoders.py:154-176). The edge-layout implementation pays a
full (B,n)x(n,m) syndrome matmul and a full VN gather per row — O(m) full
passes per iteration, ~200x more work than the information that actually
changes. This implementation exploits that a row update touches only that
row's <= dmax variables:

    v2c_r       = posterior[vars_r] - c2v[r]          (gather, lazy v2c —
                                                       VN refresh is idempotent)
    new_c2v_r   = CN update (min-sum or tanh-product) (elementwise, (B,dmax))
    posterior  += scatter(new_c2v_r - c2v[r])         ((B,dmax) scatter-add)
    syn_est    ^= flips_r @ H[vars_r]                 ((B,dmax)x(dmax,m) matmul
                                                       — exact integer XOR
                                                       maintenance of H.e mod 2)
    latch convergence; converged shots freeze (delta forced to 0), so the
    final posterior sign vector IS each shot's at-convergence estimate —
    matching the reference's immediate per-shot return.

Per-iteration cost drops from O(m.(n.cmax + n.m)) to O(m.(dmax.m + m)) per
shot. Iteration counting, per-layer exit granularity, priors, beta/eps all
match the reference; the posterior is maintained incrementally (+delta), so
floating-point association differs from the reference's full re-sum — same
statistical-parity class as the mxu paths (DIVERGENCES.md). The edge-layout
implementations remain the bit-exact parity oracle.
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
_TANH_FLOOR = 1e-12


def supports(layers: Optional[LayerSchedule]) -> bool:
    """Sequential path applies when every layer is a single row."""
    return layers is not None and int(np.max(layers.sizes)) <= 1


def make_seq_decoder(graph: TannerGraph, cfg: DecoderConfig,
                     layers: Optional[LayerSchedule] = None,
                     kind: str = "MS"):
    if layers is None:
        layers = build_layers(graph.H, cfg.schedule)
    assert supports(layers), "sequential path requires 1-row layers"
    m, n, dmax = graph.m, graph.n, graph.dmax
    f32 = jnp.float32

    # Row order of the serial schedule (layers of size 1, possibly with
    # empty padding layers — drop those).
    order = np.asarray([int(layers.rows[l, 0]) for l in range(layers.n_layers)
                        if int(layers.sizes[l]) == 1], dtype=np.int32)
    n_steps = order.shape[0]

    # Static tables (host NumPy; embedded as constants at trace time).
    row_vars = np.minimum(graph.row_vars[:m], n - 1).astype(np.int32)  # (m, dmax)
    row_mask = np.asarray(graph.row_mask[:m])                          # (m, dmax)
    # H rows gathered per variable-slot of each check row: (m, dmax, m)
    # would be huge; instead gather columns of H on the fly from H_T.
    H_T = np.asarray(graph.H.T, dtype=np.float32)                      # (n, m)
    row_par = (np.asarray(graph.H).sum(axis=1) % 2).astype(np.float32)  # (m,)

    beta = f32(cfg.beta)
    clamp = f32(1.0 - cfg.eps)
    max_iter = int(cfg.max_iter)
    kind = kind.upper()

    def _cn(mv, mask, syn_sign_r):
        """Check-node update on one row's (B, dmax) v2c block."""
        if kind == "MS":
            sign = 1.0 - 2.0 * (mv < 0).astype(f32)
            a = jnp.where(mask, jnp.abs(mv), jnp.inf)
            min1 = jnp.min(a, axis=-1, keepdims=True)
            first = jnp.argmin(a, axis=-1)
            a2 = jnp.where(jnp.arange(dmax) == first[..., None], jnp.inf, a)
            min2 = jnp.min(a2, axis=-1, keepdims=True)
            min1 = jnp.where(jnp.isinf(min1), 0.0, min1)
            min2 = jnp.where(jnp.isinf(min2), 0.0, min2)
            parity = jnp.sum(jnp.where(mask, mv < 0, False), axis=-1,
                             keepdims=True)
            prod_sign = 1.0 - 2.0 * (parity & 1).astype(f32)
            mag = jnp.where(jnp.abs(mv) == min1, min2, min1)
            out = beta * syn_sign_r[:, None] * prod_sign * sign * mag
        else:  # BP tanh product
            t = jnp.tanh(mv * 0.5)
            t = jnp.where(mask, t, 1.0)
            t_sgn = jnp.where(t < 0, -1.0, 1.0)
            t = t_sgn * jnp.maximum(jnp.abs(t), _TANH_FLOOR)
            prod = jnp.prod(t, axis=-1, keepdims=True)
            th2 = jnp.clip(prod / t, -clamp, clamp)
            out = syn_sign_r[:, None] * 2.0 * jnp.arctanh(th2)
        return jnp.where(mask, out, 0.0)

    def decode(syndromes, p):
        B = syndromes.shape[0]
        syn_f = jnp.asarray(syndromes).astype(f32)                  # (B, m)
        p = jnp.asarray(p, dtype=f32)
        L_ch = jnp.log((1.0 - p) / jnp.maximum(p, _PRIOR_EPS))
        syn_sign = jnp.where(syn_f == 1.0, f32(-1.0), f32(1.0))

        e0 = L_ch < 0.0                       # uniform initial hard decision
        syn0 = jnp.where(e0, jnp.asarray(row_par)[None, :],
                         0.0) * jnp.ones((B, 1), f32)

        def one_row(step, carry, it):
            c2v, posterior, syn_est, done, it_lat = carry
            r = jnp.asarray(order)[step]
            vars_r = jax.lax.dynamic_index_in_dim(
                jnp.asarray(row_vars), r, keepdims=False)            # (dmax,)
            mask_r = jax.lax.dynamic_index_in_dim(
                jnp.asarray(row_mask), r, keepdims=False)            # (dmax,)
            c2v_r = jax.lax.dynamic_index_in_dim(c2v, r, axis=1,
                                                 keepdims=False)     # (B, dmax)
            pos_r = jnp.take(posterior, vars_r, axis=1)              # (B, dmax)
            mv = jnp.where(mask_r[None], pos_r - c2v_r, 0.0)

            syn_sign_r = jnp.take_along_axis(
                syn_sign, jnp.broadcast_to(r, (B, 1)), axis=1)[:, 0]
            new_c2v = _cn(mv, mask_r[None], syn_sign_r)

            active = ~done
            delta = jnp.where(mask_r[None] & active[:, None],
                              new_c2v - c2v_r, 0.0)                  # (B, dmax)
            c2v = jax.lax.dynamic_update_index_in_dim(
                c2v, c2v_r + delta, r, axis=1)
            posterior = posterior.at[:, vars_r].add(delta)

            # Exact incremental syndrome maintenance: only this row's vars
            # can change sign, so XOR the flipped columns of H into syn_est.
            e_old = pos_r < 0.0
            e_new = (pos_r + delta) < 0.0
            flips = ((e_old != e_new) & mask_r[None]).astype(f32)    # (B, dmax)
            h_rows = jnp.take(jnp.asarray(H_T), vars_r, axis=0)      # (dmax, m)
            syn_delta = jnp.mod(jnp.dot(flips, h_rows,
                                        preferred_element_type=f32), 2.0)
            syn_est = jnp.abs(syn_est - syn_delta)                   # XOR on 0/1

            ok = jnp.all(syn_est == syn_f, axis=-1)
            newly = ok & active
            it_lat = jnp.where(newly, it + 1, it_lat)
            done = done | ok
            return c2v, posterior, syn_est, done, it_lat

        def body(carry):
            it = carry[0]
            state = jax.lax.fori_loop(
                0, n_steps, lambda s, c: one_row(s, c, it), carry[1:])
            return (it + 1,) + tuple(state)

        def cond(carry):
            return (carry[0] < max_iter) & (~jnp.all(carry[4]))

        carry = (
            jnp.int32(0),
            jnp.zeros((B, m, dmax), f32),
            jnp.full((B, n), L_ch, f32),
            syn0,
            jnp.zeros((B,), bool),
            jnp.full((B,), max_iter, jnp.int32),
        )
        _, _, posterior, _, done, it_lat = jax.lax.while_loop(cond, body, carry)
        e_hat = posterior < 0.0   # frozen at convergence for done shots
        return DecodeResult(e_hat=e_hat.astype(jnp.int8), n_iter=it_lat,
                            converged=done, posterior=posterior)

    return decode


def make_ms_seq_decoder(graph, cfg, layers=None):
    return make_seq_decoder(graph, cfg, layers=layers, kind="MS")


def make_bp_seq_decoder(graph, cfg, layers=None):
    return make_seq_decoder(graph, cfg, layers=layers, kind="BP")
