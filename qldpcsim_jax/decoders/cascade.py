"""Cascaded straggler compaction for iterative decoders.

Problem: a batched lax.while_loop runs until ALL shots converge, so at
realistic p a handful of hard shots drag the whole batch through max_iter
iterations (the reference exits per shot, simulator.py:244 + decoders.py:175).

Solution (in-jit, shard_map-safe): decode the full batch with a shallow
iteration cap; the unconverged tail — typically a few percent — is compacted
to the front (difficulty-ordered) and re-decoded from scratch at the next
stage's deeper cap in fixed-size WINDOWS inside a lax.while_loop, with the
remaining stages nested inside each window body. MS/BP are deterministic
functions of the syndrome, so a from-scratch re-decode reproduces the
continued trajectory exactly: results, posteriors and iteration counts are
bit-identical to a single full-depth decode (tests/test_tworound.py).

Windowing is capacity-independent — zero failures cost zero trips, a
failure spike just runs more trips of the one compiled window shape — so
correctness never depends on the failure rate, only throughput does (a
fixed-capacity buffer with a lax.cond overflow guard collapses at high
p). Serial
schedules additionally carry a cond-free high-p guard: when >2/3 of the
batch fails stage 1, intermediate stages run zero trips and a catch-all
pass decodes the tail at full depth directly. No collectives run anywhere
in the loops, so the cascade is safe under shard_map.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from qldpcsim_jax.decoders.common import DecodeResult

import os

# Difficulty-ordered refinement buffers (see the compaction key comment in
# make_cascade). Default on: the ordering rides the gather the cascade
# already pays. QLDPC_CASCADE_ORDER=0 restores pure lane-ascending
# compaction (counters are bit-exact either way).
_ORDER_BY_WEIGHT = os.environ.get("QLDPC_CASCADE_ORDER", "1") != "0"


def default_stages(max_iter: int, batch_hint: int = 4096) -> List[Tuple[int, float]]:
    """Stage plan (iters, capacity fraction of the original batch) for
    LP-code MS-layered workloads: a 4-iteration full-batch sweep converges
    the bulk of shots; shrinking refinement stages soak up the tail. On the
    flagship (LP118_0, p=0.05) 7.0% of shots are unconverged after 4
    iterations (fits the 1/8 stage) and 1.7% after 10 (fits the 1/32
    stage). The windowed refinement is capacity-independent, so these
    numbers only tune throughput, never correctness."""
    if max_iter <= 12:
        return [(max_iter, 1.0)]
    stages = [(4, 1.0)]
    if max_iter > 24:
        stages.append((10, 1.0 / 8.0))
        stages.append((max_iter, 1.0 / 32.0))
    else:
        stages.append((max_iter, 1.0 / 8.0))
    return stages


def make_cascade(decoder_factory, graph, cfg, layers,
                 stages: Optional[List[Tuple[int, float]]] = None):
    """Wrap decoder_factory(graph, cfg, layers) with cascaded WINDOWED
    compaction.

    stages: [(iters, window_frac), ...]; the first stage runs on the full
    batch (its frac is ignored), the last stage must use cfg.max_iter.

    Stage k >= 1 compacts the currently-unconverged lanes to the front
    (difficulty-ordered — see below) and re-decodes them from scratch at
    the deeper cap in FIXED-SIZE WINDOWS inside a lax.while_loop, with
    the remaining stages NESTED inside each window body: zero failures
    cost zero trips, a failure spike just runs more trips of the one
    compiled window shape, and deep stages always work on window-sized
    sub-buffers (gather/scatter locality). A fixed-capacity buffer with a
    lax.cond overflow guard would re-decode the WHOLE current set at full
    depth whenever a stage's tail exceeded its capacity — which at high p
    (e.g. Tanner MS-serial at p >= 0.07, where ~20%+ of shots never
    converge) is every chunk. Windowing is
    capacity-independent, so the stage plan only tunes throughput, never
    triggers a cliff.

    MS/BP are deterministic functions of the syndrome, so a from-scratch
    re-decode reproduces the continued trajectory exactly: results,
    posteriors and iteration counts are bit-identical to a single
    full-depth decode (tests/test_tworound.py), and counters are
    invariant to the window partition.
    """
    if stages is None:
        stages = default_stages(cfg.max_iter)
    assert stages[-1][0] == cfg.max_iter
    if len(stages) == 1:
        return decoder_factory(graph, cfg, layers=layers)

    decs = [decoder_factory(graph, dataclasses.replace(cfg, max_iter=it),
                            layers=layers) for it, _ in stages]
    # High-p guard (gated intermediate skip + full-depth catch-all): ON
    # for SERIAL schedules, whose beyond-threshold tail (Tanner MS-serial
    # p=0.10) collapses the plain windowed cascade; OFF for F/L, where the
    # zero-trip catch-all loop is pure cost and the flagship never runs in
    # that regime.
    highp_guard = cfg.schedule.upper() == "S"

    def decode(syndromes, p):
        B = syndromes.shape[0]
        syn0 = jnp.asarray(syndromes)

        def tail_order(syn_cur, conv, n_pad):
            """Window order over unconverged lanes: failed first; among
            them, by syndrome weight so refinement blocks hold stragglers
            of similar depth (the gather is paid either way). Any order
            is counter-bit-exact:
            per-shot decodes are lane-independent."""
            Bc = conv.shape[0]
            if _ORDER_BY_WEIGHT:
                key = jnp.where(conv, jnp.float32(2e9),
                                jnp.sum(syn_cur, axis=1, dtype=jnp.float32))
                order = jnp.argsort(key, stable=True)
            else:
                order = jnp.argsort(conv, stable=True)
            return jnp.concatenate(
                [order.astype(jnp.int32),
                 jnp.full((n_pad - Bc,), Bc, jnp.int32)])

        def refine(level, syn_cur, res, gate=None, use_dec=None,
                   shared_order=None):
            """Windowed refinement of res's unconverged lanes at
            stages[level:], NESTED: each window's own stragglers refine
            inside the window body on the window-sized context, so deep
            stages gather/scatter sub-buffers, not the full batch.
            `gate` (traced bool) ANDs into the
            window loop's condition — False runs zero trips. `use_dec`
            overrides the stage decoder and disables nesting (the
            catch-all pass); `shared_order` passes a precomputed
            (order, n_failed) so the gated stage and its catch-all don't
            both pay the argsort."""
            if level == len(stages):
                return res
            iters_k, frac_k = stages[level]
            Bc = syn_cur.shape[0]
            W = min(Bc, max(64, -(-int(B * frac_k) // 64) * 64))
            n_pad = -(-Bc // W) * W
            e, it, conv, post = res

            if shared_order is None:
                order = tail_order(syn_cur, conv, n_pad)
                n_failed = jnp.sum(~conv)
            else:
                order, n_failed = shared_order
            has_post = post is not None

            def cond_fn(c):
                live = c[0] < n_failed
                return live if gate is None else live & gate

            def body(c):
                lo, e, it, conv, post = c
                idx = jax.lax.dynamic_slice(order, (lo,), (W,))
                wv = (lo + jnp.arange(W)) < n_failed
                idx = jnp.where(wv, idx, Bc)    # pad lanes: dropped below
                sub_syn = syn_cur[idx]
                dec = decs[level] if use_dec is None else use_dec
                r = dec(sub_syn, p)
                if use_dec is None:
                    se, sit, sconv, spost = refine(
                        level + 1, sub_syn,
                        (r.e_hat, r.n_iter, r.converged, r.posterior))
                else:
                    # catch-all windows already decode at full depth —
                    # still-unconverged lanes are genuine failures, not
                    # capacity drops; no nested refinement
                    se, sit, sconv, spost = (r.e_hat, r.n_iter,
                                             r.converged, r.posterior)
                e = e.at[idx].set(se, mode="drop")
                it = it.at[idx].set(sit, mode="drop")
                conv = conv.at[idx].set(sconv, mode="drop")
                if post is not None:
                    post = post.at[idx].set(spost, mode="drop")
                return lo + W, e, it, conv, post

            _, e, it, conv, post = jax.lax.while_loop(
                cond_fn, body,
                (jnp.int32(0), e, it, conv,
                 post if has_post else None))
            return e, it, conv, post

        r0 = decs[0](syn0, p)
        res = (r0.e_hat, r0.n_iter, r0.converged, r0.posterior)
        if len(stages) > 2 and highp_guard:
            # High-p guard, cond-free (the config-4 tail fix): when
            # most of the batch fails stage 1 (e.g. Tanner MS-serial at
            # p=0.10, ~98% fail the 4-iteration head), the shallow
            # intermediate stages cannot pay for themselves — their
            # window loops run ZERO trips (gate ANDed into the loop
            # condition) and a catch-all pass decodes the tail at FULL
            # depth directly in stage-2-sized windows. Both loops SHARE
            # one order/argsort (when the gate lets the normal path run,
            # the catch-all runs zero trips and never reads it; when
            # heavy, the normal path changed nothing and the order is
            # exactly the catch-all's). Bit-exact: a from-scratch
            # full-depth decode of any failed lane yields the same
            # (e_hat, n_iter, posterior).
            lv = 1
            frac1 = stages[lv][1]
            W1 = min(B, max(64, -(-int(B * frac1) // 64) * 64))
            n_pad1 = -(-B // W1) * W1
            n_f1 = jnp.sum(~r0.converged)
            order1 = tail_order(syn0, r0.converged, n_pad1)
            heavy = n_f1 > (2 * B) // 3
            res = refine(lv, syn0, res, gate=~heavy,
                         shared_order=(order1, n_f1))
            res = refine(lv, syn0, res, gate=heavy, use_dec=decs[-1],
                         shared_order=(order1, n_f1))
            e, it, conv, post = res
        else:
            e, it, conv, post = refine(1, syn0, res)
        return DecodeResult(e_hat=e, n_iter=it, converged=conv,
                            posterior=post)

    return decode


def make_tworound(decoder_factory, graph, cfg, layers, round1_iters: int,
                  cap_frac: float = 0.125):
    """Two-stage special case (kept for explicit round1_iters configs)."""
    if round1_iters >= cfg.max_iter:
        return decoder_factory(graph, cfg, layers=layers)
    return make_cascade(decoder_factory, graph, cfg, layers,
                        stages=[(round1_iters, 1.0), (cfg.max_iter, cap_frac)])
