"""GPU kernel (Pallas, Triton route): normalized min-sum over circulant-lifted
(QC) codes, every iteration of a shot tile in one launch.

The flagship decode path (reference hot loop: decoders.py:153-177). The XLA
formulation (decoders/ms_mxu.py) runs each layer as a few small fusions
inside a `lax.while_loop`, so a layered iteration costs ~15 layers of
launches plus one host read of the loop predicate. Here one program owns a
tile of `block_shots` shots and runs its whole iteration loop, exiting as
soon as every shot of its tile has converged.

Layout: shots are the contiguous (last) axis. Block-row i of H = lift(S, L)
connects check row r of the block to variable j*L + (r + s_ij) % L, so the
check-side view of a variable block is a ref load with the integer row
index `j*L + (iota + s) % L` — no gather tables and no incidence matmuls.
The decoder state (c2v messages and the posterior, ~9.6 KB per shot) does
not fit in a block's shared memory at any useful tile size, so it lives in
global scratch outputs that stay resident in L2. A posterior block is
written back through the same row index it was read with, so every element
is stored by the thread that loaded it; a block barrier after each
block-row orders those stores before loads with other row shifts.

Semantics match decoders/ms_mxu.py at the same granularity: beta
normalization, value-equality min/min2 extrinsics, sign(0)=+1, syndrome sign
folding, layered schedule = block-row groups, flooding = one snapshot pass.
Convergence is checked once per iteration (the reference checks after every
layer): the reported iteration count is the reference's for every shot
whose mid-iteration match survives the rest of its iteration, and converged
shots freeze, so the final sign vector is the at-convergence estimate. The
incremental posterior changes floating-point association, so this path is
in the statistical-parity class with `impl="mxu"`; `impl="edge"` stays the
bit-exact oracle (DIVERGENCES.md).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qldpcsim_jax.decoders.common import DecodeResult, DecoderConfig, LayerSchedule
from qldpcsim_jax.ops.qc import QCStructure, block_groups_of_layers

_PRIOR_EPS = 1e-9
_BIG = 1e30  # stand-in for +inf in min reductions

BLOCK_SHOTS = 32
NUM_WARPS = 4


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _uniform_degree(st: QCStructure) -> Optional[int]:
    degs = {len(st.blocks_of_row(i)) for i in range(st.m_b)}
    return degs.pop() if len(degs) == 1 else None


def supports(st: Optional[QCStructure], cfg: DecoderConfig,
             layers: Optional[LayerSchedule]) -> bool:
    """MS decoding, schedule F or block-row-aligned L, a power-of-two lift
    size (Triton tensors are power-of-two shaped) and the same number of
    circulants in every block-row (one shift table, no masked slots).

    A layer of whole block-rows touches each variable block at most once,
    so the kernel runs its block-rows one after another reading the live
    posterior, which equals the layer's snapshot for every block it
    reads."""
    if st is None or cfg.dec_type.upper() != "MS":
        return False
    sched = cfg.schedule.upper()
    aligned = sched == "F" or (sched == "L" and (
        layers is None or block_groups_of_layers(layers, st) is not None))
    return aligned and _pow2(st.L) and _uniform_degree(st) is not None


def _make_kernel(L: int, m_b: int, n_b: int, D: int, beta: float, Bt: int,
                 flooding: bool, interpret: bool):
    """The kernel for one code shape. Everything code-specific beyond the
    shape (which variable block and shift each slot has) is read from the
    `tab` input, so the block-row loop is a loop, not an unrolled program,
    and every cascade stage of a code shares one compiled kernel (the
    iteration cap is an input too)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    f32 = jnp.float32

    def barrier():
        # Interpret mode runs a program's statements in order.
        if not interpret:
            plgpu.debug_barrier()

    def kernel(syn_ref, lch_ref, tab_ref, maxit_ref, post_ref, c2v_ref,
               conv_ref, it_ref, *snap):
        cols = pl.ds(pl.program_id(0) * Bt, Bt)
        iota = jnp.arange(L, dtype=jnp.int32)

        def rows(i, d):
            """Variable rows of slot d of block-row i, in check-row order."""
            return tab_ref[i, d] * L + (iota + tab_ref[i, D + d]) % L

        def c2v_rows(i, d):
            return pl.ds((i * D + d) * L, L)

        lch = jnp.broadcast_to(lch_ref[0, cols][None, :], (L, Bt))

        def init_post(j, c):
            post_ref[pl.ds(j * L, L), cols] = lch
            return c

        def init_c2v(k, c):
            c2v_ref[pl.ds(k * L, L), cols] = jnp.zeros((L, Bt), f32)
            return c

        jax.lax.fori_loop(0, n_b, init_post, 0)
        jax.lax.fori_loop(0, m_b * D, init_c2v, 0)
        barrier()

        def row_update(i, src_ref, active):
            ss = 1.0 - 2.0 * syn_ref[pl.ds(i * L, L), cols]
            m1 = jnp.full((L, Bt), _BIG, f32)
            m2 = jnp.full((L, Bt), _BIG, f32)
            par = jnp.zeros((L, Bt), jnp.bool_)
            slots = []
            for d in range(D):
                pos = src_ref[rows(i, d), cols]
                old = c2v_ref[c2v_rows(i, d), cols]
                v = pos - old
                a = jnp.abs(v)
                neg = v < 0.0
                par = par != neg
                is_new = a < m1
                m2 = jnp.where(is_new, m1, jnp.minimum(m2, a))
                m1 = jnp.where(is_new, a, m1)
                slots.append((a, neg, old, pos))
            m1 = jnp.where(m1 >= _BIG, 0.0, m1)
            m2 = jnp.where(m2 >= _BIG, 0.0, m2)
            coef = beta * ss * jnp.where(par, -1.0, 1.0)
            for d in range(D):
                a, neg, old, pos = slots[d]
                mag = jnp.where(a == m1, m2, m1)
                new = jnp.where(active, coef * jnp.where(neg, -mag, mag), old)
                c2v_ref[c2v_rows(i, d), cols] = new
                r = rows(i, d)
                # layered: `pos` is the live value (each variable block is
                # touched once per block-row group); flooding read a snapshot
                cur = post_ref[r, cols] if flooding else pos
                post_ref[r, cols] = cur + (new - old)

        def check_row(i, bad):
            par = jnp.zeros((L, Bt), jnp.bool_)
            for d in range(D):
                par = par != (post_ref[rows(i, d), cols] < 0.0)
            syn = syn_ref[pl.ds(i * L, L), cols] > 0.5
            return bad + jnp.sum((par != syn).astype(f32), axis=0)

        def body(carry):
            it, done, it_lat = carry
            active = (done == 0)[None, :]
            src = post_ref
            if flooding:
                src = snap[0]

                def copy(j, c):
                    src[pl.ds(j * L, L), cols] = post_ref[pl.ds(j * L, L),
                                                          cols]
                    return c

                jax.lax.fori_loop(0, n_b, copy, 0)
                barrier()

            def one_row(i, c):
                row_update(i, src, active)
                barrier()
                return c

            jax.lax.fori_loop(0, m_b, one_row, 0)
            ok = jax.lax.fori_loop(0, m_b, check_row,
                                   jnp.zeros((Bt,), f32)) == 0.0
            newly = ok & (done == 0)
            it_lat = jnp.where(newly, it + 1, it_lat)
            done = jnp.where(ok, 1, done)
            return it + 1, done, it_lat

        max_iter = jnp.min(maxit_ref[0, cols])

        def cond(carry):
            it, done, _ = carry
            return (it < max_iter) & (jnp.min(done) == 0)

        _, done, it_lat = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), jnp.zeros((Bt,), jnp.int32),
             jnp.broadcast_to(max_iter, (Bt,))))
        conv_ref[0, cols] = done
        it_ref[0, cols] = it_lat

    return kernel


def make_ms_qc_decoder(st: QCStructure, cfg: DecoderConfig,
                       layers: Optional[LayerSchedule] = None,
                       block_shots: int = BLOCK_SHOTS,
                       num_warps: int = NUM_WARPS, interpret: bool = False):
    """Build decode(syndromes, p) -> DecodeResult running the Triton QC
    min-sum kernel. Batches of any size are padded up to a multiple of
    `block_shots` with zero syndromes (which converge at iteration 1)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    if not supports(st, cfg, layers):
        raise ValueError("qc kernel needs MS, schedule F or block-row-aligned "
                         "L, and a circulant-lifted H with a power-of-two "
                         "lift size and uniform block-row degree")
    if not _pow2(block_shots):
        raise ValueError(f"block_shots must be a power of two, got "
                         f"{block_shots}")
    flooding = cfg.schedule.upper() == "F"
    L, m_b, n_b, D = st.L, st.m_b, st.n_b, _uniform_degree(st)
    Bt = block_shots
    tab = np.array([[j for j, _ in st.blocks_of_row(i)]
                    + [s for _, s in st.blocks_of_row(i)]
                    for i in range(m_b)], np.int32)           # (m_b, 2D)
    kernel = _make_kernel(L, m_b, n_b, D, float(cfg.beta), Bt, flooding,
                          interpret)
    n, max_iter = st.n, int(cfg.max_iter)

    def decode(syndromes, p):
        B = syndromes.shape[0]
        Bp = B + (-B) % Bt
        syn_T = jnp.asarray(syndromes).astype(jnp.float32).T     # (m, B)
        syn_T = jnp.pad(syn_T, ((0, 0), (0, Bp - B)))
        p = jnp.asarray(p, jnp.float32)
        lch = jnp.log((1.0 - p) / jnp.maximum(p, _PRIOR_EPS))
        f32, i32 = jnp.float32, jnp.int32
        out_shape = [
            jax.ShapeDtypeStruct((n, Bp), f32),                  # posterior
            jax.ShapeDtypeStruct((m_b * D * L, Bp), f32),        # c2v scratch
            jax.ShapeDtypeStruct((1, Bp), i32),                  # converged
            jax.ShapeDtypeStruct((1, Bp), i32),                  # iterations
        ]
        if flooding:
            out_shape.append(jax.ShapeDtypeStruct((n, Bp), f32))  # snapshot
        outs = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(Bp // Bt,),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
            interpret=interpret,
            name="ms_qc_decode",
        )(syn_T, jnp.broadcast_to(lch, (1, Bp)), jnp.asarray(tab),
          jnp.full((1, Bp), max_iter, i32))
        post, conv, it = outs[0].T[:B], outs[2][0, :B], outs[3][0, :B]
        return DecodeResult(e_hat=(post < 0.0).astype(jnp.int8), n_iter=it,
                            converged=conv > 0, posterior=post)

    return decode
