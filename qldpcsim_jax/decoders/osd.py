"""Batched ordered-statistics (OSD) post-decoder
(reference: decoders.py:299-369, Panteleev–Kalachev style least-reliable basis).

Algorithm parity with the reference:
  * reliabilities from ±100-saturated posterior LLRs (decoders.py:320-326),
    ascending argsort puts least-reliable columns first;
  * "least-reliable basis": the first rank(H) columns of the permuted H that
    are linearly independent in permuted order (the reference's greedy
    rank-increase loop, decoders.py:330-342, is exactly this — independence
    is basis-free, so a single elimination sweep gives the same set);
  * candidate enumeration flips the `order` lowest-indexed information
    positions and solves for the basis positions, keeping the minimum-weight
    candidate with first-wins ties (decoders.py:347-366).

Deliberate divergence (documented in DIVERGENCES.md): the reference's
`e_hat_perm_tmp = e_hat_perm` aliasing makes flip patterns accumulate across
the enumeration (landmine L4), so reference OSD-λ tests a scrambled subset of
patterns; this implementation enumerates all 2^λ patterns independently
(the intended textbook behavior — qBLER can only improve).

Design: one pass of bit-packed (uint32 over the check dimension)
Gaussian elimination per shot builds an RREF basis of selected columns plus
"tag" vectors expressing each basis vector over the original selected columns.
Solving a candidate is then a single gather of pivot bits + one XOR-fold of
tags; the 2^order enumeration reuses the factorization (the reference
recomputes a dense REF per pattern, decoders.py:355). Everything is batched
over shots and static-shaped (r = rank(H) is data-independent).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from qldpcsim_jax import gf2

u32 = jnp.uint32
_LLR_SAT = 100.0  # decoders.py:320-322


@dataclasses.dataclass(frozen=True)
class OSDStatic:
    """Static (data-independent) OSD quantities for one H."""

    m: int
    n: int
    r: int      # rank(H)
    mW: int     # uint32 words covering m
    rW: int     # uint32 words covering r
    cols_packed: np.ndarray  # (n, mW) uint32: column j of H, bits over checks

    @staticmethod
    def build(H: np.ndarray) -> "OSDStatic":
        H = (np.asarray(H) % 2).astype(np.uint8)
        m, n = H.shape
        r = gf2.rank(H)
        mW = max(1, -(-m // 32))
        rW = max(1, -(-max(r, 1) // 32))
        cols = np.zeros((n, mW), dtype=np.uint32)
        weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
        padded = np.zeros((mW * 32, n), dtype=np.uint32)
        padded[:m] = H
        cols[:] = (padded.reshape(mW, 32, n) * weights[None, :, None]).sum(axis=1, dtype=np.uint32).T
        return OSDStatic(m=m, n=n, r=r, mW=mW, rW=rW, cols_packed=cols)


def _pack_bits(bits, W):
    """(..., <=32*W) 0/1 -> (..., W) uint32, LSB-first."""
    pad = W * 32 - bits.shape[-1]
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.astype(u32).reshape(bits.shape[:-1] + (W, 32))
    weights = (u32(1) << jnp.arange(32, dtype=u32))
    return jnp.sum(bits * weights, axis=-1, dtype=u32)


def _xor_fold(x, axis):
    """XOR-reduce along an axis."""
    return jax.lax.reduce(x, np.uint32(0), jax.lax.bitwise_xor, (axis,))


def _bit_at(words, pos, valid):
    """Extract bit `pos` from packed rows. words: (..., W), pos: (...,) int32."""
    pos_c = jnp.maximum(pos, 0)
    w = jnp.take_along_axis(words, (pos_c >> 5)[..., None], axis=-1)[..., 0]
    bit = (w >> (pos_c.astype(u32) & u32(31))) & u32(1)
    return jnp.where(valid, bit, u32(0))


def _popcount(words):
    return jnp.sum(jax.lax.population_count(words), axis=-1).astype(jnp.int32)


def make_osd(H: np.ndarray, order: int):
    """Build osd(e_hat, syndromes, posterior) -> e_hat' for OSD-`order`.

    Inputs are batched: e_hat (B, n) int, syndromes (B, m) int,
    posterior (B, n) float32. Only call on decoder-failed shots (the engine
    compacts those; reference reaches OSD only without early return,
    decoders.py:179-180).
    """
    st = OSDStatic.build(H)
    m, n, r, mW, rW = st.m, st.n, st.r, st.mW, st.rW
    # Host-side NumPy constants (embedded at trace time; no device touch).
    cols_packed = st.cols_packed               # (n, mW) np.uint32
    H_T_f32 = np.ascontiguousarray((np.asarray(H) % 2).T).astype(np.float32)
    order = int(order)
    if order < 0:
        raise ValueError(f"osd order must be >= 0, got {order}")
    # The candidate enumeration unrolls all 2^order patterns at TRACE time
    # (the factorize-once design makes each pattern one gather+XOR-fold, but
    # the graph still grows as 2^order): order 8 would emit a 256-way unroll
    # and silently explode compile time. Note this order-λ semantics
    # ("all 2^λ patterns over the λ least-reliable info positions",
    # decoders.py:347-350) is the reference's, NOT the textbook
    # "all weight-<=λ patterns over the whole info set" — λ beyond ~6 is
    # outside the regime either formulation targets.
    if order > 6:
        raise ValueError(
            f"osd order {order} > 6: the 2^order candidate enumeration is "
            "unrolled at trace time and would explode compile time; use a "
            "smaller order (reference OSD-λ enumerates 2^λ patterns on the "
            "λ least-reliable info positions — λ<=2 is typical)")
    iota_r = np.arange(r, dtype=np.int32)

    def _eliminate(colsP):
        """Per-batch elimination over permuted packed columns.

        colsP: (B, n, mW). Returns (tags (B,r,rW), pivots (B,r), sel (B,n)).
        """
        B = colsP.shape[0]

        def step(j, carry):
            basis, tags, pivots, sel, cnt = carry
            v = colsP[:, j]                                   # (B, mW)
            valid = pivots >= 0                               # (B, r)
            # bits of v at each existing pivot position:
            h = _bit_at(jnp.broadcast_to(v[:, None, :], (B, r, mW)), pivots, valid)
            hmask = (u32(0) - h)                              # 0 or 0xFFFFFFFF
            v = v ^ _xor_fold(basis & hmask[:, :, None], 1)
            t = _xor_fold(tags & hmask[:, :, None], 1)        # (B, rW)

            nonzero = jnp.any(v != 0, axis=-1)                # (B,)
            # lowest set bit of v
            w0 = jnp.argmax(v != 0, axis=-1).astype(jnp.int32)
            word = jnp.take_along_axis(v, w0[:, None], axis=-1)[:, 0]
            low = word & (u32(0) - word)
            bitpos = jnp.round(jnp.log2(jnp.maximum(low.astype(jnp.float32), 1.0))).astype(jnp.int32)
            piv_new = w0 * 32 + bitpos                        # (B,)

            # tag of the new basis vector: t ^ e_cnt
            cnt_c = jnp.minimum(cnt, r - 1)
            self_bit = (u32(1) << (cnt_c.astype(u32) & u32(31)))
            t_new = t ^ jnp.where(
                (jnp.arange(rW)[None, :] == (cnt_c >> 5)[:, None]) & nonzero[:, None],
                self_bit[:, None], u32(0))

            # back-eliminate the new pivot from existing basis rows
            hb = _bit_at(basis, jnp.broadcast_to(piv_new[:, None], (B, r)), valid) \
                * nonzero[:, None].astype(u32)
            hbmask = (u32(0) - hb)
            basis = basis ^ (hbmask[:, :, None] & v[:, None, :])
            tags = tags ^ (hbmask[:, :, None] & t_new[:, None, :])

            # insert the new basis vector at slot cnt
            slot = (iota_r[None, :] == cnt_c[:, None]) & nonzero[:, None] & (cnt < r)[:, None]
            basis = jnp.where(slot[:, :, None], v[:, None, :], basis)
            tags = jnp.where(slot[:, :, None], t_new[:, None, :], tags)
            pivots = jnp.where(slot, piv_new[:, None], pivots)

            upd = nonzero & (cnt < r)
            sel = sel.at[:, j].set(upd)
            cnt = cnt + upd.astype(jnp.int32)
            return basis, tags, pivots, sel, cnt

        carry = (
            jnp.zeros((B, r, mW), u32),
            jnp.zeros((B, r, rW), u32),
            jnp.full((B, r), -1, jnp.int32),
            jnp.zeros((B, n), bool),
            jnp.zeros((B,), jnp.int32),
        )
        # Early exit once every shot has found its r basis columns — the
        # least-reliable-first order typically completes after ~r + slack
        # columns, halving the sweep vs a fixed 0..n loop.
        def w_cond(jc):
            j, c = jc
            return (j < n) & jnp.any(c[4] < r)

        def w_body(jc):
            j, c = jc
            return j + 1, step(j, c)

        _, (basis, tags, pivots, sel, cnt) = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), carry))
        return basis, tags, pivots, sel

    def osd(e_hat, syndromes, posterior):
        B = e_hat.shape[0]
        f32 = jnp.float32
        e_hat = e_hat.astype(jnp.int32)

        # 1. reliability order (decoders.py:320-326)
        llr = jnp.clip(posterior.astype(f32), -_LLR_SAT, _LLR_SAT)
        prob = 1.0 / (1.0 + jnp.exp(llr))
        reliability = jnp.maximum(prob, 1.0 - prob)
        perm = jnp.argsort(reliability, axis=-1).astype(jnp.int32)  # (B, n)

        # 2. least-reliable basis via one elimination sweep
        colsP = jnp.asarray(cols_packed)[perm]                  # (B, n, mW)
        basis, tags, pivots, sel = _eliminate(colsP)
        pivots_valid = pivots >= 0

        # 3. base "information" estimate: e_hat restricted to non-basis columns
        e_perm = jnp.take_along_axis(e_hat, perm, axis=-1)          # (B, n)
        e_info_perm = jnp.where(sel, 0, e_perm)                     # info bits only
        # s0 = syndrome XOR H_perm[:, info] @ e_info  (packed over checks)
        e_info_orig = jnp.zeros_like(e_hat)
        e_info_orig = jax.vmap(lambda z, pm, v: z.at[pm].set(v))(e_info_orig, perm, e_info_perm)
        s_info = jnp.mod(jnp.dot(e_info_orig.astype(f32), H_T_f32,
                                 preferred_element_type=f32), 2.0)
        s0 = jnp.mod(syndromes.astype(f32) + s_info, 2.0)
        s0P = _pack_bits(s0.astype(jnp.int32), mW)                  # (B, mW)

        # 4. the `order` lowest-indexed info positions (flip candidates)
        notsel = (~sel).astype(jnp.int32)
        crank = jnp.cumsum(notsel, axis=-1)
        flip_pos = []     # permuted index of k-th flip position
        flip_colP = []    # its packed column
        flip_ebit = []    # current e_hat bit there
        for k in range(order):
            posk = jnp.argmax(crank == (k + 1), axis=-1).astype(jnp.int32)  # (B,)
            flip_pos.append(posk)
            flip_colP.append(jnp.take_along_axis(
                colsP, posk[:, None, None], axis=1)[:, 0, :])               # (B, mW)
            flip_ebit.append(jnp.take_along_axis(e_perm, posk[:, None], axis=-1)[:, 0])

        base_info_w = jnp.sum(e_info_perm, axis=-1).astype(jnp.int32)

        # 5. enumerate 2^order candidates, reusing the factorization
        best_weight = None
        best_x = None
        best_w = None
        for w in range(2 ** order):
            sJ = s0P
            winfo = base_info_w
            for k in range(order):
                if (w >> k) & 1:
                    sJ = sJ ^ flip_colP[k]
                    winfo = winfo + 1 - 2 * flip_ebit[k]
            h = _bit_at(jnp.broadcast_to(sJ[:, None, :], (B, r, mW)), pivots, pivots_valid)
            hmask = (u32(0) - h)
            x = _xor_fold(tags & hmask[:, :, None], 1)              # (B, rW)
            weight = _popcount(x) + winfo
            if best_weight is None:
                best_weight, best_x, best_w = weight, x, jnp.zeros((B,), jnp.int32)
            else:
                better = weight < best_weight                        # first-wins ties
                best_weight = jnp.where(better, weight, best_weight)
                best_x = jnp.where(better[:, None], x, best_x)
                best_w = jnp.where(better, w, best_w)

        # 6. reconstruct the winning candidate
        slot_of = jnp.cumsum(sel.astype(jnp.int32), axis=-1) - 1     # (B, n)
        xbits = _bit_at(jnp.broadcast_to(best_x[:, None, :], (B, n, rW)),
                        slot_of, sel).astype(jnp.int32)
        flipmask = jnp.zeros((B, n), jnp.int32)
        for k in range(order):
            sel_k = ((best_w >> k) & 1).astype(jnp.int32)            # (B,)
            onehot = (jnp.arange(n, dtype=jnp.int32)[None, :] == flip_pos[k][:, None])
            flipmask = flipmask ^ (onehot.astype(jnp.int32) * sel_k[:, None])
        e_perm_new = jnp.where(sel, xbits, e_perm ^ flipmask)
        inv_perm = jnp.argsort(perm, axis=-1)
        e_new = jnp.take_along_axis(e_perm_new, inv_perm, axis=-1)
        return e_new.astype(jnp.int8)

    return osd
