"""Native GF(2) CSS encoder — tableau-free replacement for the reference's
Stim encoder synthesis (stim.Tableau.from_stabilizers + to_circuit at
simulator.py:78-86; precedent: the reference's deleted
`stimEncoder.css_ldpc_encoder_no_tableau`, SURVEY.md §2.6).

A CSS stabilizer state is tracked in the binary symplectic picture as a
codeword frame (x | z): x-component in the coset space of rowspace(Hx) +
span(Lx), z-component likewise with Z-type generators. Encoding a maximally
mixed logical state (the reference's DEPOLARIZE1(0.75) on the k logical
inputs, simulator.py:86) corresponds to sampling uniform logical bits and a
uniform stabilizer coset. The frame is annihilated by both check matrices, so
it never affects syndromes — property-tested in tests/test_channel.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from qldpcsim_jax import gf2


@dataclasses.dataclass(frozen=True)
class CSSEncoder:
    """Samples random codeword frames of a CSS code on device."""

    n: int
    k: int
    Gx: np.ndarray  # (rx, n) row basis of Hx  (X-type stabilizer generators)
    Gz: np.ndarray  # (rz, n) row basis of Hz
    Lx: np.ndarray  # (k, n) logical X ops
    Lz: np.ndarray  # (k, n) logical Z ops

    @staticmethod
    def build(Hx: np.ndarray, Hz: np.ndarray) -> "CSSEncoder":
        Hx = np.asarray(Hx) % 2
        Hz = np.asarray(Hz) % 2
        Lx, Lz = gf2.logical_ops(Hx, Hz)
        return CSSEncoder(
            n=Hx.shape[1],
            k=Lx.shape[0],
            Gx=gf2.row_basis(Hx),
            Gz=gf2.row_basis(Hz),
            Lx=Lx,
            Lz=Lz,
        )

    def encode(self, key, batch: int):
        """Sample `batch` random codeword frames.

        Returns (frame_x, frame_z): (batch, n) int8 symplectic components with
        Hz @ frame_x == 0 and Hx @ frame_z == 0 (mod 2). Uniform over logical
        states and stabilizer cosets — the GF(2) equivalent of the reference's
        random-codespace-state preparation.
        """
        f32 = jnp.float32
        kx, kz, ka, kb = jax.random.split(key, 4)
        u = jax.random.bernoulli(kx, 0.5, (batch, self.k)).astype(f32)
        v = jax.random.bernoulli(kz, 0.5, (batch, self.k)).astype(f32)
        a = jax.random.bernoulli(ka, 0.5, (batch, self.Gx.shape[0])).astype(f32)
        b = jax.random.bernoulli(kb, 0.5, (batch, self.Gz.shape[0])).astype(f32)
        Lx = jnp.asarray(self.Lx, f32)
        Lz = jnp.asarray(self.Lz, f32)
        Gx = jnp.asarray(self.Gx, f32)
        Gz = jnp.asarray(self.Gz, f32)
        frame_x = jnp.mod(u @ Lx + a @ Gx, 2.0).astype(jnp.int8)
        frame_z = jnp.mod(v @ Lz + b @ Gz, 2.0).astype(jnp.int8)
        return frame_x, frame_z
