"""Batched decode-event classification.

Reference counters (simulator.py:291-315):
  decSuccessExact — decoded error equals the true error on both components
  decSuccessDegen — reference-compatible "degenerate" test: integer matmul
                    WITHOUT mod 2 equals zero (zero support overlap), the
                    reference's landmine L2 (simulator.py:296-298, minus the
                    live breakpoint). Practically never fires — kept for
                    parity-comparable output.
  DecFailures_X/Z — decoded syndrome mismatches the observed syndrome
                    (simulator.py:300-303)

Honest classification (the capability the reference deleted — SURVEY.md §2.6):
a residual r = err XOR e_hat with zero syndrome is either a stabilizer
(harmless) or a logical operator. Over GF(2), r in rowspace(H) iff
null_space(H) @ r == 0 (rowspace = kernel-of-nullspace duality), so both
checks are single matmuls against precomputed static bases:
  stabilizer  : Hz r == 0 (mod 2)  and  Knull_x r == 0 (mod 2)
  logical     : Hz r == 0 (mod 2)  and  Lz r != 0 (mod 2)
with Lz @ r giving exactly WHICH logical qubits flipped (symplectic pairing).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from qldpcsim_jax import gf2


@dataclasses.dataclass(frozen=True)
class ClassifierStatic:
    """Static matrices for classification of one CSS code."""

    Hx: np.ndarray
    Hz: np.ndarray
    Kx: np.ndarray  # null_space(Hx): r in rowspace(Hx) iff Kx r == 0
    Kz: np.ndarray  # null_space(Hz)
    Lx: np.ndarray
    Lz: np.ndarray

    @staticmethod
    def build(Hx: np.ndarray, Hz: np.ndarray) -> "ClassifierStatic":
        Hx = np.asarray(Hx) % 2
        Hz = np.asarray(Hz) % 2
        Lx, Lz = gf2.logical_ops(Hx, Hz)
        return ClassifierStatic(
            Hx=Hx, Hz=Hz,
            Kx=gf2.null_space(Hx), Kz=gf2.null_space(Hz),
            Lx=Lx, Lz=Lz,
        )


def classify_batch(st: ClassifierStatic, err_x, err_z, ex_hat, ez_hat,
                   sy_z, sy_x, valid=None):
    """Classify one batch of decode outcomes. Returns a dict of int32 counts.
    `valid` masks out padding shots in a partial final chunk. All device-side.

    Contract: sy_z == Hz err_x (mod 2) and sy_x == Hx err_z (mod 2) — the
    engine always derives syndromes from the sampled errors, which lets the
    failure test ride the residual matmul (see below). The syndrome args are
    kept for interface clarity and future non-derived-syndrome callers."""
    f32 = jnp.float32
    rx = jnp.logical_xor(err_x.astype(bool), ex_hat.astype(bool))
    rz = jnp.logical_xor(err_z.astype(bool), ez_hat.astype(bool))

    exact = (~jnp.any(rx, axis=-1)) & (~jnp.any(rz, axis=-1))

    # ONE residual matmul per side against [H.T | L.T] (integer counts, no
    # mod): the H block serves both the reference-compatible degenerate test
    # (zero overlap, L2) and — via parity — the undetected-residual test; the
    # L block gives the logical-flip syndrome. bf16 inputs (0/1 exact), f32
    # matmul accumulation.
    k = st.Lx.shape[0]
    bf = jnp.bfloat16
    HLz_T = jnp.asarray(np.concatenate([st.Hz.T, st.Lz.T], axis=1), bf)
    HLx_T = jnp.asarray(np.concatenate([st.Hx.T, st.Lx.T], axis=1), bf)
    mz = st.Hz.shape[0]
    mx = st.Hx.shape[0]
    ov_x = jnp.dot(rx.astype(bf), HLz_T, preferred_element_type=f32)
    ov_z = jnp.dot(rz.astype(bf), HLx_T, preferred_element_type=f32)
    ref_degen = (~exact) & jnp.all(ov_x[:, :mz] == 0.0, axis=-1) \
        & jnp.all(ov_z[:, :mx] == 0.0, axis=-1)

    # Honest classification (parity of the integer overlap counts).
    def _odd(v):
        return v - 2.0 * jnp.floor(v * 0.5) > 0.5

    undet_x = ~jnp.any(_odd(ov_x[:, :mz]), axis=-1)
    undet_z = ~jnp.any(_odd(ov_z[:, :mx]), axis=-1)

    # Decoder failures: decoded syndrome mismatch (simulator.py:300-303).
    # The engine's syndromes satisfy sy_z == Hz err_x (mod 2) by construction
    # (channel/depolarizing.py), so H e_hat != sy componentwise iff
    # H (e_hat XOR err) has an odd overlap somewhere — the residual parity
    # already computed above; no extra matmul against e_hat is needed.
    fail_x = ~undet_x
    fail_z = ~undet_z
    if k:
        log_x = jnp.any(_odd(ov_x[:, mz:]), axis=-1) & undet_x
        log_z = jnp.any(_odd(ov_z[:, mx:]), axis=-1) & undet_z
    else:
        log_x = jnp.zeros(rx.shape[0], bool)
        log_z = jnp.zeros(rz.shape[0], bool)
    stab_x = undet_x & (~log_x)
    stab_z = undet_z & (~log_z)
    success_honest = stab_x & stab_z

    if valid is None:
        valid = jnp.ones(rx.shape[0], bool)
    i32 = jnp.int32

    def _c(mask):
        return jnp.sum(mask & valid, dtype=i32)

    counts = {
        "decSuccessExact": _c(exact),
        "decSuccessDegen": _c(ref_degen),
        "DecFailures_X": _c(fail_x),
        "DecFailures_Z": _c(fail_z),
        "successStabilizer": _c(success_honest),
        "logicalErrors_X": _c(log_x),
        "logicalErrors_Z": _c(log_z),
    }
    return counts
