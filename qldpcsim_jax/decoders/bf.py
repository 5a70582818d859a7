"""Batched bit-flipping decoder (reference: decoders.py:74-102).

Per iteration: count unsatisfied checks per variable through the residual
syndrome (nuc = r @ H), flip every variable whose count exceeds half its check
degree, recompute the residual, stop on zero residual or after max_iter
(default 50, decoders.py:74). The reference's empty-input branch returning a
bare array (landmine L7) is not reproduced — this decoder always returns a
DecodeResult.

Residual semantics (DIVERGENCES.md "BF residual"): the reference computes
r = bool(H @ e_hat) XOR syndrome (decoders.py:93-95) — ANY overlap, not
overlap parity — so for rows touching >= 2 flipped variables it differs from
the standard mod-2 residual and the two fixed points differ. Default here is
the correct parity residual; cfg.bf_residual="bool" reproduces the
reference's semantics exactly (tested against a case where they diverge in
tests/test_decoders.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qldpcsim_jax.decoders.common import DecodeResult, DecoderConfig, TannerGraph


def make_bf_decoder(graph: TannerGraph, cfg: DecoderConfig):
    import numpy as np

    f32 = jnp.float32
    # Host-side NumPy constants (embedded at trace time; no device touch).
    H = np.asarray(graph.H, dtype=np.float32)     # (m, n)
    H_T = np.ascontiguousarray(H.T)
    half_deg = np.sum(H, axis=0) * 0.5            # (n,) nChecks/2
    max_iter = int(cfg.bf_max_iter)
    ref_bool = cfg.bf_residual == "bool"
    if cfg.bf_residual not in ("mod2", "bool"):
        raise ValueError(f"bf_residual must be 'mod2' or 'bool', "
                         f"got {cfg.bf_residual!r}")

    def decode(syndromes, p=None):
        B = syndromes.shape[0]
        syn_f = syndromes.astype(f32)             # (B, m)

        def cond(c):
            it, e, r, done, it_lat = c
            return (it < max_iter) & (~jnp.all(done))

        def body(c):
            it, e, r, done, it_lat = c
            nuc = jnp.dot(r, H, preferred_element_type=f32)          # (B, n)
            flip = nuc > half_deg
            e_new = jnp.logical_xor(e, flip)
            overlap = jnp.dot(e_new.astype(f32), H_T,
                              preferred_element_type=f32)
            # "bool": any-overlap (reference decoders.py:93-95);
            # "mod2": overlap parity (standard bit-flipping residual).
            s_hat = ((overlap > 0.0).astype(f32) if ref_bool
                     else jnp.mod(overlap, 2.0))
            r_new = jnp.abs(s_hat - syn_f)                            # XOR on 0/1
            # Freeze converged shots (the reference returns immediately).
            e = jnp.where(done[:, None], e, e_new)
            r = jnp.where(done[:, None], r, r_new)
            ok = jnp.all(r == 0.0, axis=-1)
            newly = ok & (~done)
            it_lat = jnp.where(newly, it + 1, it_lat)
            return it + 1, e, r, done | ok, it_lat

        carry = (
            jnp.int32(0),
            jnp.zeros((B, graph.n), bool),
            syn_f,
            jnp.zeros((B,), bool),
            jnp.full((B,), max_iter, jnp.int32),
        )
        _, e, _, done, it_lat = jax.lax.while_loop(cond, body, carry)
        return DecodeResult(e_hat=e.astype(jnp.int8), n_iter=it_lat,
                            converged=done, posterior=None)

    return decode
