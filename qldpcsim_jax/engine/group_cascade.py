"""Group-deferred cascade: opt-in straggler deferral across dispatch groups.

Head cascade stages run in-chunk; each chunk's unconverged shots defer their
records into a fixed-capacity buffer, and the whole dispatch group's
stragglers finish in dense full-depth windows at group level. Determinism
makes every per-shot result — e_hat, n_iter, posterior — bit-identical to
the in-chunk cascade (same decision tree: head result if converged early,
else from-scratch deeper decode), so counters are unchanged
(tests/test_engine.py::test_group_cascade_bit_exact).

Off by default (opt-in: QLDPC_GROUP_CASCADE=1): it has not been measured
on a GPU, and it lost to the in-chunk cascade on the accelerator it was
written for (PERF.md). Kept as tested, bit-exact machinery (the
defer/retry pattern and the record-extraction matmul are reusable).

Reference-relative anchor: the per-shot early exit the reference gets for
free from its serial loop (decoders.py:175-176, simulator.py:244) — this
module is one batched-execution answer to it, the in-chunk cascade
(decoders/cascade.py) is the winning one.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp


def enabled(dcfg) -> bool:
    """Opt-in gate: deep iterative decoders only, env-controlled."""
    return (dcfg.dec_type.upper() in ("MS", "BP")
            and int(dcfg.max_iter) > 12
            and os.environ.get("QLDPC_GROUP_CASCADE") == "1")


class GroupCascade:
    """Group-deferred cascade machinery for one ShotPipeline.

    Built behind the decoder-factory seam: holds the head (shallow, in-chunk)
    and tail (full-depth window) cascade decoders plus the defer/finish
    bodies. The pipeline delegates its multi-chunk body here when
    `enabled(dcfg)`.
    """

    def __init__(self, pipe, dcfg, graph_x, graph_z, layers_x, layers_z):
        from qldpcsim_jax.decoders import make_decoder
        from qldpcsim_jax.decoders.cascade import default_stages, make_cascade

        self.pipe = pipe
        ds = default_stages(dcfg.max_iter)
        # Split point: all but the LAST stage run in-chunk (the head); only
        # the full-depth refinement defers to group level. An earlier split
        # (defer everything after stage 1) would move too much: the X-or-Z
        # straggler union after 4 iterations is ~13.5% of the flagship's
        # chunk, and shuffling that much record state through group
        # windows costs more than the per-chunk stage padding it saves.
        split = len(ds) - 1
        head_stages = ds[:split]
        head_cfg = dataclasses.replace(dcfg, max_iter=head_stages[-1][0],
                                       round1_iters=-1)

        def _plain_factory(graph2, cfg2, layers=None):
            return make_decoder(
                graph2, dataclasses.replace(cfg2, round1_iters=-1),
                layers=layers)

        self.dec_head_x = make_cascade(_plain_factory, graph_x, head_cfg,
                                       layers_x, stages=head_stages)
        self.dec_head_z = make_cascade(_plain_factory, graph_z, head_cfg,
                                       layers_z, stages=head_stages)
        # Window-level refinement: the remaining stages with capacity
        # fractions re-based to the window size.
        tail_stages = [(it, 1.0 if k == 0 else frac / ds[split][1])
                       for k, (it, frac) in enumerate(ds[split:])]
        self.dec_tail_x = make_cascade(_plain_factory, graph_x, dcfg,
                                       layers_x, stages=tail_stages)
        self.dec_tail_z = make_cascade(_plain_factory, graph_z, dcfg,
                                       layers_z, stages=tail_stages)
        # Stragglers are the UNION of X- and Z-side head failures (~2x the
        # per-side rate: ~3.4% of the flagship's 4096-shot chunks after the
        # 10-iteration head at p=0.05) — the cap guards to 12.5% of the
        # chunk. Overflowing chunks (very high p) zero their defer slots
        # and flag gcOverflow; simulate_p re-runs the group through the
        # non-deferring path.
        self.defer_cap = min(pipe.per_dev, 512)
        self.window = 2048

    def chunk_body_defer(self, tile_keys, p, n_valid):
        """One chunk of the group-deferred cascade: sample + HEAD decode
        (cascade stage 1 only) + classify the converged shots; unconverged
        shots defer their (channel error, syndrome) records to the group
        buffer. A chunk whose stragglers overflow the deferral capacity
        (very high p) runs the full in-chunk cascade instead — correctness
        never depends on the straggler rate."""
        from qldpcsim_jax.engine.montecarlo import _compact_indices
        from qldpcsim_jax.engine.classify import classify_batch

        pipe = self.pipe
        err_x, err_z, sy_z, sy_x = pipe._sample_chunk(tile_keys, p)
        prior = p / 3.0
        B = err_x.shape[0]
        valid = jnp.arange(B) < n_valid
        F = self.defer_cap
        res_x = self.dec_head_x(sy_z, prior)
        res_z = self.dec_head_z(sy_x, prior)
        strag = (~(res_x.converged & res_z.converged)) & valid
        n_strag = jnp.sum(strag)
        # NO lax.cond here: a conditional with a heavy fallback branch
        # inside the chunk scan is paid every iteration. On overflow this chunk's stragglers are dropped from the defer
        # buffer and `gcOverflow` tells simulate_p to re-run the whole
        # dispatch group through the non-deferring path instead.
        overflow = n_strag > F
        i8 = jnp.int8
        bf16 = jnp.bfloat16

        # Straggler record extraction as ONE one-hot matmul (each
        # output element picks a single 0/1, syndrome-bit or e_hat-bit term
        # — exact in bf16). The head e_hat and converged flags of BOTH
        # sides ride along so the group finish re-decodes ONLY the failed
        # side(s) of each straggler (a converged side's head result is
        # already its final result — it froze at convergence).
        didx = _compact_indices(strag, F, fill=0)
        dvalid = (jnp.arange(F) < n_strag) & ~overflow
        onehot = (didx[:, None] == jnp.arange(B, dtype=jnp.int32)[None, :]
                  ).astype(bf16)
        data = jnp.concatenate(
            [err_x.astype(bf16), err_z.astype(bf16),
             sy_z.astype(bf16), sy_x.astype(bf16),
             res_x.e_hat.astype(bf16), res_z.e_hat.astype(bf16),
             res_x.converged[:, None].astype(bf16),
             res_z.converged[:, None].astype(bf16)], axis=1)
        picked = jnp.dot(onehot, data, preferred_element_type=jnp.float32)
        n = err_x.shape[1]
        mz, mx = sy_z.shape[1], sy_x.shape[1]
        o = 0
        cols = {}
        for name, width in (("err_x", n), ("err_z", n), ("sy_z", mz),
                            ("sy_x", mx), ("ex", n), ("ez", n),
                            ("cx", 1), ("cz", 1)):
            cols[name] = picked[:, o:o + width]
            o += width
        defer = dict(
            err_x=cols["err_x"].astype(err_x.dtype),
            err_z=cols["err_z"].astype(err_z.dtype),
            sy_z=cols["sy_z"].astype(i8), sy_x=cols["sy_x"].astype(i8),
            ex=cols["ex"].astype(i8), ez=cols["ez"].astype(i8),
            cx=cols["cx"][:, 0] > 0.5, cz=cols["cz"][:, 0] > 0.5,
            dv=dvalid)

        done = valid & ~strag
        counts = classify_batch(pipe.classifier, err_x, err_z,
                                res_x.e_hat, res_z.e_hat, sy_z, sy_x,
                                valid=done)
        # Iteration counts of CONVERGED sides are final even for deferred
        # shots — count them here; the finish adds only tail-decoded sides.
        itx_ok = valid & (~strag | res_x.converged)
        itz_ok = valid & (~strag | res_z.converged)
        counts["nIterAccX"] = jnp.sum(jnp.where(itx_ok, res_x.n_iter, 0),
                                      dtype=jnp.int32)
        counts["nIterAccZ"] = jnp.sum(jnp.where(itz_ok, res_z.n_iter, 0),
                                      dtype=jnp.int32)
        counts["gcOverflow"] = overflow.astype(jnp.int32)
        return counts, defer

    def group_finish(self, defer, p):
        """Dense full-depth refinement of a whole dispatch group's cascade
        stragglers, PER SIDE: each side's failed shots are compacted into
        their own work queue and decoded in fixed-size windows inside a
        lax.while_loop — zero stragglers cost zero trips, every window is a
        full batch of genuine failures of THAT side, and a straggler's
        converged side is never re-decoded (its carried head result is
        final — the union of X/Z failures is ~2x either side's rate, so
        per-side queues halve the refinement decode volume). Tail results
        scatter back into the record arrays and ONE masked classification
        pass over all records produces the counters. With OSD enabled each
        window's still-unconverged shots get their OSD pass right here
        (posteriors from the window decode)."""
        from qldpcsim_jax.engine.montecarlo import (_COUNTER_KEYS,
                                                    _compact_indices)
        from qldpcsim_jax.engine.classify import classify_batch

        pipe = self.pipe
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in defer.items()}
        dv = flat["dv"]
        N = dv.shape[0]
        W = min(self.window, N)
        N_pad = -(-N // W) * W
        prior = p / 3.0
        i8, i32, f32 = jnp.int8, jnp.int32, jnp.float32

        workx = dv & ~flat["cx"]
        workz = dv & ~flat["cz"]
        # rank of each record in its side queue — locates the record's tail
        # result in the COMPACT per-side result buffers below
        rankx = (jnp.cumsum(workx) - 1).astype(i32)
        rankz = (jnp.cumsum(workz) - 1).astype(i32)

        def side_pass(work, sy_flat, dec_tail, osd):
            q = _compact_indices(work, N_pad, fill=N)
            n_work = jnp.sum(work)
            res0 = jnp.zeros((N_pad, pipe.n), i8)

            def cond(c):
                return c[0] < n_work

            def body(c):
                lo, res, it_acc = c
                idx = jax.lax.dynamic_slice(q, (lo,), (W,))
                wv = (lo + jnp.arange(W)) < n_work
                syn = sy_flat[idx].astype(f32)
                r = dec_tail(syn, prior)
                e = r.e_hat
                if pipe.use_osd:
                    e = pipe._apply_osd(osd, e, r.posterior, syn,
                                        (~r.converged) & wv)
                # window results land CONTIGUOUSLY at queue offset lo
                res = jax.lax.dynamic_update_slice(res, e.astype(i8),
                                                   (lo, 0))
                it_acc = it_acc + jnp.sum(jnp.where(wv, r.n_iter, 0),
                                          dtype=i32)
                return lo + W, res, it_acc

            _, res, it_acc = jax.lax.while_loop(
                cond, body, (jnp.int32(0), res0, jnp.int32(0)))
            return res, it_acc

        resx, it_x = side_pass(workx, flat["sy_z"], self.dec_tail_x,
                               getattr(pipe, "osd_x", None))
        resz, it_z = side_pass(workz, flat["sy_x"], self.dec_tail_z,
                               getattr(pipe, "osd_z", None))

        # One windowed classification sweep over ALL deferred records:
        # converged sides use their carried head e_hat, tail-decoded sides
        # gather theirs from the compact result buffers by queue rank.
        qu = _compact_indices(dv, N_pad, fill=N)
        n_u = jnp.sum(dv)
        init = {k: jnp.int32(0) for k in _COUNTER_KEYS
                if not k.startswith("nIter")}

        def u_cond(c):
            return c[0] < n_u

        def u_body(c):
            lo, tot = c
            idx = jax.lax.dynamic_slice(qu, (lo,), (W,))
            wv = (lo + jnp.arange(W)) < n_u
            cx = flat["cx"][idx]
            cz = flat["cz"][idx]
            ex = jnp.where(cx[:, None], flat["ex"][idx], resx[rankx[idx]])
            ez = jnp.where(cz[:, None], flat["ez"][idx], resz[rankz[idx]])
            cnt = classify_batch(pipe.classifier, flat["err_x"][idx],
                                 flat["err_z"][idx], ex, ez,
                                 flat["sy_z"][idx].astype(f32),
                                 flat["sy_x"][idx].astype(f32), valid=wv)
            return lo + W, {k: tot[k] + cnt[k] for k in tot}

        _, tot = jax.lax.while_loop(u_cond, u_body, (jnp.int32(0), init))
        tot["nIterAccX"] = it_x
        tot["nIterAccZ"] = it_z
        return tot

    def multi_chunk_body(self, keys, p, n_valids):
        """G fused chunks in one dispatch under the group-deferred cascade:
        lax.scan over per-chunk tile keys, straggler records deferred, ONE
        group-level refinement pass — still inside this jit."""

        def step(_, xs):
            k, nv = xs
            return None, self.chunk_body_defer(k, p, nv)

        _, (per_chunk, defer) = jax.lax.scan(step, None, (keys, n_valids))
        counts = {k: jnp.sum(v, axis=0) for k, v in per_chunk.items()}
        extra = self.group_finish(defer, p)
        return {k: counts[k] + extra.get(k, jnp.int32(0))
                for k in counts}
