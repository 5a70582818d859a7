"""Depolarizing channel + syndrome extraction, fully on device.

Replaces the reference's Stim sampling step (simulator.py:196-197) and
error-recording CNOT/H ladders (simulator.py:99-118): under DEPOLARIZE1(p)
each qubit independently suffers I with probability 1-p and X, Y, Z with
probability p/3 each (PAULI_CHANNEL_1(p/3,p/3,p/3), simulator.py:107). The
X-component errX is set for {X, Y}; the Z-component errZ for {Y, Z}. The
measured stabilizer record of the corrupted codeword equals
  sy_z = Hz @ errX mod 2   (Z-checks detect X errors)
  sy_x = Hx @ errZ mod 2   (X-checks detect Z errors)
independent of the encoded logical/stabilizer frame, which is why no tableau
synthesis is needed (tested against the explicit encoder in
tests/test_channel.py).

RNG discipline (fixing reference landmine L10 — np.random.seed never reached
Stim's sampler): a deterministic jax.random key hierarchy
seed -> p-point -> chunk, so runs are reproducible and sharding-layout
invariant (SURVEY.md §5.8).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _u32_threshold(q):
    """round(q * 2^32) as uint32 (clamped). P(bits32 < t) = t / 2^32, so the
    threshold quantization error is <= 2^-24 relative (f32 mantissa) — the
    same class as the f32-uniform formulation it replaces, which quantizes
    the draw itself to 24 bits."""
    t = jnp.round(jnp.asarray(q, jnp.float32) * 4294967296.0)
    return jnp.clip(t, 0.0, 4294967040.0).astype(jnp.uint32)  # largest f32 < 2^32


def sample_depolarizing(key, p, shape):
    """Sample (errX, errZ) bool arrays of `shape` under DEPOLARIZE1(p).

    One 32-bit draw per qubit partitions [0, 2^32) into
    [0, p/3) -> X, [p/3, 2p/3) -> Y, [2p/3, p) -> Z, [p, 1) -> I (scaled by
    2^32). Raw integer threshold compares skip the int->float conversion of
    jax.random.uniform at identical (2^-24) threshold resolution."""
    p = jnp.asarray(p, dtype=jnp.float32)
    bits = jax.random.bits(key, shape, jnp.uint32)
    err_x = bits < _u32_threshold(2.0 * p / 3.0)
    err_z = (bits >= _u32_threshold(p / 3.0)) & (bits < _u32_threshold(p))
    return err_x, err_z


def syndromes_of(err_x, err_z, Hx_T, Hz_T):
    """Syndromes of an error pair via matmuls mod 2.

    Hx_T, Hz_T: (n, m_*) float32 transposed parity-check matrices.
    Returns (sy_z, sy_x) float32 0/1 arrays, ordered like the reference's
    measurement record (sy_z first; simulator.py:141-144, 249-250).
    """
    f32 = jnp.float32
    bf = jnp.bfloat16
    # bf16 inputs are exact for 0/1 entries and the accumulation is f32
    # (preferred_element_type), so the mod-2 of the integer overlap count
    # is exact.
    sy_z = jnp.mod(jnp.dot(err_x.astype(bf), jnp.asarray(Hz_T, bf),
                           preferred_element_type=f32), 2.0)
    sy_x = jnp.mod(jnp.dot(err_z.astype(bf), jnp.asarray(Hx_T, bf),
                           preferred_element_type=f32), 2.0)
    return sy_z, sy_x


def sample_shot_batch(key, p, n, batch, Hx_T, Hz_T):
    """Sample one batch of shots: errors plus both syndromes."""
    err_x, err_z = sample_depolarizing(key, p, (batch, n))
    sy_z, sy_x = syndromes_of(err_x, err_z, Hx_T, Hz_T)
    return err_x, err_z, sy_z, sy_x


def sample_shot_tiles(keys, p, n, tile, Hx_T, Hz_T):
    """Sample a batch composed of fixed-size tiles, one PRNG key per tile.

    keys: (n_tiles, 2) uint32 PRNG keys (one per GLOBAL tile index). The tile
    is the sharding-invariant unit of randomness: a run with the same global
    tile stream produces bit-identical shots regardless of how tiles are
    distributed over devices (SURVEY.md §7 "multi-host RNG discipline").
    Returns (n_tiles * tile, n) batched errors and syndromes.
    """
    err_x, err_z = jax.vmap(
        lambda k: sample_depolarizing(k, p, (tile, n)))(keys)
    err_x = err_x.reshape(-1, n)
    err_z = err_z.reshape(-1, n)
    sy_z, sy_x = syndromes_of(err_x, err_z, Hx_T, Hz_T)
    return err_x, err_z, sy_z, sy_x


