"""Per-shot NumPy oracle decoders implementing the reference semantics
(qLDPCsim/decoders.py), written independently of both the reference's code and
the batched JAX implementations. Used only by tests as a parity oracle
(SURVEY.md §4.2/§4.5).
"""

from __future__ import annotations

import numpy as np

from qldpcsim_jax import gf2


def ms_decode(H, syndrome, p, max_iter, layers, beta=0.75):
    """Normalized min-sum, reference semantics (decoders.py:110-182):
    layered CN update, global VN update, per-layer early exit, beta
    normalization, min/min2 with value-equality ties, sign(0)=+1."""
    H = np.asarray(H)
    m, n = H.shape
    sup = H == 1
    L = np.float32(np.log((1 - p) / max(p, 1e-9)))
    v2c = np.where(sup, L, 0.0).astype(np.float32)
    c2v = np.zeros((m, n), np.float32)
    syn_sign = np.where(np.asarray(syndrome) == 1, -1.0, 1.0).astype(np.float32)
    e = np.zeros(n, np.int8)
    post = np.full(n, L, np.float32)
    for it in range(max_iter):
        for layer in layers:
            for i in layer:
                msk = sup[i]
                vals = v2c[i, msk]
                if vals.size == 0:
                    c2v[i] = 0.0
                    continue
                absv = np.abs(vals)
                s = np.where(vals < 0, np.float32(-1.0), np.float32(1.0))
                am = int(np.argmin(absv))
                min1 = absv[am]
                tmp = absv.copy()
                tmp[am] = np.inf
                min2 = tmp.min()
                if np.isinf(min2):
                    min2 = np.float32(0.0)
                prod = np.float32(1.0) if (np.count_nonzero(vals < 0) % 2 == 0) else np.float32(-1.0)
                mag = np.where(absv == min1, min2, min1)
                row = np.zeros(n, np.float32)
                row[msk] = np.float32(beta) * syn_sign[i] * prod * s * mag
                c2v[i] = row
            post = (L + c2v.sum(axis=0)).astype(np.float32)
            e = (post < 0).astype(np.int8)
            if np.array_equal((H.astype(np.int64) @ e) % 2, syndrome):
                return e, it + 1, post, True
            v2c = np.where(sup, post[None, :] - c2v, 0.0).astype(np.float32)
    return e, max_iter, post, False


def ms_decode_mixed(H, syndrome, p, max_iter, layers, beta=0.75):
    """Normalized min-sum with the reference's EXACT dtype mix
    (decoders.py:147-177): L_ch is a float64 Python scalar, msg_c2v is a
    dense float32 matrix, msg_v2c becomes float64 after the first VN update
    (posterior f64 - c2v f32), and VNsum is np.sum(axis=0) over the dense
    f32 matrix (NumPy pairwise order).

    Why this exists: on maximally regular codes (bicycle: every row weight
    18, every column weight 9) the CN update's exact-value tie condition
    (|msg| == min, decoders.py:167-168) is dtype-sensitive — f64 messages
    break ties the pure-f32 framework path resolves differently, which
    diverges ~46% of shots at p=0.05 while remaining bit-exact on every
    other library code. This replica pins the reference's behavior
    bit-for-bit (tests/test_reference_parity.py) so that divergence is
    provably precision-induced, not semantic."""
    H = np.asarray(H)
    m, n = H.shape
    sup = H == 1
    L = np.log((1 - p) / max(p, 1e-9))  # float64 scalar
    v2c = np.where(sup, L, 0.0).astype(np.float32)
    c2v = np.zeros((m, n), np.float32)
    syn_sign = np.where(np.asarray(syndrome)[:, None] == 1, -1.0, 1.0)
    e = np.zeros(n, np.int8)
    for it in range(max_iter):
        for layer in layers:
            rows = np.asarray(layer)
            if rows.size == 0:
                continue
            Hl = H[rows, :]
            absv = np.abs(v2c[rows, :])
            s = np.sign(v2c[rows, :])
            s[s == 0] = 1.0
            prod = np.prod(np.where(Hl == 1, s, 1.0), axis=1, keepdims=True)
            masked = np.where(Hl == 1, absv, np.inf)
            min1 = np.min(masked, axis=1, keepdims=True)
            am = np.argmin(masked, axis=1)
            abs2 = absv.copy()
            abs2[range(abs2.shape[0]), am] = np.inf
            min2 = np.min(np.where(Hl == 1, abs2, np.inf), axis=1,
                          keepdims=True)
            min1 = np.where(np.isinf(min1), 0.0, min1)
            min2 = np.where(np.isinf(min2), 0.0, min2)
            coef = beta * syn_sign[rows] * prod
            cur = np.abs(v2c[rows, :])
            # Reference denominator sign_msg + (1-H): = sign on support; = 2
            # off-support, where the second branch can leak coef*min2/2 into
            # c2v whenever a row's min |msg| is exactly 0 (only infs are
            # zeroed, decoders.py:167-169) — replicated faithfully.
            den = s + (1 - Hl)
            out = np.where(np.logical_and(Hl == 1, cur != min1),
                           coef * min1 / den, np.inf)
            out = np.where(np.logical_and(np.isinf(out), cur == min1),
                           coef * min2 / den, out)
            c2v[rows, :] = out  # f32 store
            c2v[np.isinf(c2v)] = 0.0
            post = L + np.sum(c2v, axis=0)  # f64 = f64 + f32 pairwise sum
            e = (post < 0).astype(np.int8)
            if np.array_equal((H.astype(np.int64) @ e) % 2, syndrome):
                return e, it + 1
            v2c = np.where(sup, post[None, :] - c2v, 0.0)  # f64 onward
    return e, max_iter


def bp_decode(H, syndrome, p, max_iter, layers, eps=1e-6):
    """Sum-product BP, reference semantics (decoders.py:189-290) in float32
    with the f32-suitable tanh clamp used by the framework."""
    H = np.asarray(H)
    m, n = H.shape
    sup = H == 1
    L0 = np.float32(np.log((1 - p) / max(p, 1e-9)))
    v2c = np.where(sup, L0, 0.0).astype(np.float32)
    c2v = np.zeros((m, n), np.float32)
    clamp = np.float32(1.0 - eps)
    e = np.zeros(n, int)
    post = np.full(n, L0, np.float32)
    for it in range(max_iter):
        for layer in layers:
            for i in layer:
                msk = sup[i]
                if not msk.any():
                    continue
                t = np.tanh(v2c[i, msk].astype(np.float32) / 2)
                ts = np.where(t < 0, -1.0, 1.0).astype(np.float32)
                t = ts * np.maximum(np.abs(t), np.float32(1e-12))
                prod = np.prod(t).astype(np.float32)
                th2 = np.clip(prod / t, -clamp, clamp)
                val = (2 * np.arctanh(th2)).astype(np.float32)
                if syndrome[i]:
                    val = -val
                row = np.zeros(n, np.float32)
                row[msk] = val
                c2v[i] = row
            post = (L0 + c2v.sum(axis=0)).astype(np.float32)
            e = (post < 0).astype(int)
            v2c = np.where(sup, post[None, :] - c2v, 0.0).astype(np.float32)
            if np.array_equal((H.astype(np.int64) @ e) % 2, syndrome):
                return e, it + 1, post, True
    return e, max_iter, post, False


def bp_decode_strict(H, syndrome, p, max_iter, layers, eps=1e-9):
    """Sum-product BP with the reference's EXACT numerics
    (decoders.py:189-290): float64 messages, eps=1e-9,
    L0=log((1-p)/max(p,eps)), per-edge th2 = prod/tanh(v/2) with
    clamp-by-subtraction (|th2| >= 1-eps => th2 -= eps*sign(th2)),
    layered CN + global VN update + per-layer early exit."""
    H = np.asarray(H)
    m, n = H.shape
    sup = H == 1
    L0 = np.log((1 - p) / max(p, eps))
    v2c = np.where(sup, L0, 0.0)
    c2v = np.zeros((m, n), np.float64)
    e = np.zeros(n, int)
    post = np.full(n, L0, np.float64)
    for it in range(max_iter):
        for layer in layers:
            for i in layer:
                msk = sup[i]
                if not msk.any():
                    continue
                t = np.tanh(v2c[i, msk] / 2.0)
                prod = 1.0
                for tv in t:       # sequential product, edge order
                    prod = prod * tv
                th2 = prod / t
                big = np.abs(th2) >= 1 - eps
                th2 = np.where(big, th2 - eps * np.sign(th2), th2)
                val = 2 * np.arctanh(th2)
                if syndrome[i]:
                    val = -val
                row = np.zeros(n, np.float64)
                row[msk] = val
                c2v[i] = row
            post = L0 + c2v.sum(axis=0)
            e = (post < 0).astype(int)
            v2c = np.where(sup, post[None, :] - c2v, 0.0)
            if np.array_equal((H.astype(np.int64) @ e) % 2, syndrome):
                return e, it + 1, post, True
    return e, max_iter, post, False


def bf_decode(H, syndrome, max_iter=50, residual="mod2"):
    """Bit-flipping, reference semantics (decoders.py:74-102).

    residual="bool" reproduces the reference's residual EXACTLY
    (decoders.py:93-95: r = bool(H @ e_hat) ^ syndrome — any-overlap, not
    parity); "mod2" is the standard parity residual the framework defaults
    to (DIVERGENCES.md "BF residual")."""
    H = np.asarray(H).astype(np.int64)
    n = H.shape[1]
    deg = H.sum(axis=0)
    e = np.zeros(n, dtype=bool)
    syndrome = np.asarray(syndrome).astype(np.int64)
    r = syndrome.copy()
    for it in range(max_iter):
        nuc = r @ H
        e = e ^ (nuc > deg / 2.0)
        if residual == "bool":
            r = (H @ e > 0).astype(np.int64) ^ syndrome
        else:
            r = ((H @ e) % 2) ^ syndrome
        if r.sum() == 0:
            return e.astype(np.int8), it + 1, True
    return e.astype(np.int8), max_iter, False


def ng_decode(H, syndrome):
    """Naive-greedy, reference semantics (decoders.py:27-66): flip the
    variable touching the most failing checks, first index on ties, up to
    2n steps; a step with no positive score breaks (still counted)."""
    H = np.asarray(H).astype(np.int64)
    m, n = H.shape
    res = np.asarray(syndrome).astype(np.int64).copy()
    e = np.zeros(n, np.int8)
    steps = 0
    while res.sum() > 0 and steps < 2 * n:
        steps += 1
        scores = res @ H
        if scores.max() == 0:
            break
        v = int(np.argmax(scores))
        e[v] ^= 1
        res = res ^ H[:, v]
    return e, steps


def osd_decode(H, e_hat, syndrome, posterior, order):
    """OSD with the framework's corrected enumeration (all 2^order patterns
    on the `order` least-reliable info positions; no L4 aliasing), reference
    reliability/basis-selection semantics (decoders.py:320-344)."""
    H = np.asarray(H) % 2
    m, n = H.shape
    llr = np.clip(np.asarray(posterior, np.float32), -100.0, 100.0)
    prob = (1.0 / (1.0 + np.exp(llr))).astype(np.float32)
    reliability = np.maximum(prob, 1 - prob)
    perm = np.argsort(reliability, kind="stable")
    Hp = H[:, perm]
    rmax = gf2.rank(H)

    # first rmax independent permuted columns
    cis = []
    for j in range(n):
        if gf2.rank(Hp[:, cis + [j]]) > len(cis):
            cis.append(j)
            if len(cis) == rmax:
                break
    info = [j for j in range(n) if j not in cis]
    e_perm = np.asarray(e_hat, np.int64)[perm].copy()

    Hcis = Hp[:, cis]
    _, T, _ = gf2.rref(Hcis)

    best = None
    for w in range(2 ** order):
        cand = e_perm.copy()
        for k in range(order):
            if (w >> k) & 1:
                cand[info[k]] ^= 1
        cand_info = cand.copy()
        cand_info[cis] = 0
        sJ = (np.asarray(syndrome, np.int64) + Hp.astype(np.int64) @ cand_info) % 2
        sol = (T.astype(np.int64) @ sJ) % 2
        cand[cis] = sol[: len(cis)]
        wgt = int(cand.sum())
        if best is None or wgt < best[0]:
            best = (wgt, cand.copy())
    out = np.zeros(n, np.int8)
    out[perm] = best[1]
    return out
