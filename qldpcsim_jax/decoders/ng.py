"""Batched naive-greedy decoder (reference: decoders.py:27-66).

Per step: score every variable by the number of currently-failing checks it
touches (scores = residual @ H), flip the highest-scoring variable (first
index on ties, like np.argmax), update the residual, and repeat until the
residual clears, a step has no positive score, or 2n steps elapse
(decoders.py:47-49). A zero syndrome reports 0 steps (the reference's while
guard never fires), unlike BF/MS/BP which report 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qldpcsim_jax.decoders.common import DecodeResult, DecoderConfig, TannerGraph


def make_ng_decoder(graph: TannerGraph, cfg: DecoderConfig):
    import numpy as np

    f32 = jnp.float32
    n = graph.n
    # Host-side NumPy constants (embedded at trace time; no device touch).
    H = np.asarray(graph.H, dtype=np.float32)      # (m, n)
    H_T_bool = np.ascontiguousarray(graph.H.T != 0)  # (n, m)
    max_steps = 2 * n
    iota_n = np.arange(n, dtype=np.int32)

    def decode(syndromes, p=None):
        B = syndromes.shape[0]
        residual0 = syndromes.astype(bool)          # (B, m)

        def active_of(res, steps, broken):
            return jnp.any(res, axis=-1) & (steps < max_steps) & (~broken)

        def cond(c):
            est, res, steps, broken = c
            return jnp.any(active_of(res, steps, broken))

        def body(c):
            est, res, steps, broken = c
            act = active_of(res, steps, broken)
            steps = steps + act.astype(jnp.int32)   # step counted before scoring
            scores = jnp.dot(res.astype(f32), H, preferred_element_type=f32)
            smax = jnp.max(scores, axis=-1)
            v = jnp.argmax(scores, axis=-1).astype(jnp.int32)  # first max
            dead = act & (smax == 0.0)              # reference's break
            do_flip = act & (~dead)
            onehot = iota_n[None, :] == v[:, None]
            est = jnp.logical_xor(est, onehot & do_flip[:, None])
            col = jnp.asarray(H_T_bool)[v]           # (B, m)
            res = jnp.logical_xor(res, col & do_flip[:, None])
            return est, res, steps, broken | dead

        carry = (
            jnp.zeros((B, n), bool),
            residual0,
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool),
        )
        est, res, steps, _ = jax.lax.while_loop(cond, body, carry)
        return DecodeResult(
            e_hat=est.astype(jnp.int8),
            n_iter=steps,
            converged=~jnp.any(res, axis=-1),
            posterior=None,
        )

    return decode
