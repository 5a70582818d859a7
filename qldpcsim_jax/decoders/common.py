"""Shared decoder infrastructure: Tanner-graph edge layouts, check-node layer
schedules, and configuration/result containers.

Layout design: message-passing state lives in a padded row-major
edge layout — one (m+1, dmax) block per message direction, 64-bit-free, static
shapes — rather than the reference's dense (m, n) float matrices
(decoders.py:148-150) or per-edge Python loops (decoders.py:249-278).
Row m is a dummy row absorbing padded layer slots, so layered/serial schedules
become gather/scatter at static shapes with no ragged work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Static structure of one parity-check matrix H (host-side NumPy).

    Fields:
      H          — (m, n) int8 parity-check matrix
      row_vars   — (m+1, dmax) int32: variable index per check-row edge slot,
                   padded with n; row m is an all-pad dummy row
      row_mask   — (m+1, dmax) bool: valid edge slots
      var_rows   — (n, cmax) int32: check-row index per variable edge slot,
                   padded with m
      var_slots  — (n, cmax) int32: which dmax-slot of that row this edge is
      var_mask   — (n, cmax) bool
    """

    H: np.ndarray
    row_vars: np.ndarray
    row_mask: np.ndarray
    var_rows: np.ndarray
    var_slots: np.ndarray
    var_mask: np.ndarray

    @property
    def m(self) -> int:
        return self.H.shape[0]

    @property
    def n(self) -> int:
        return self.H.shape[1]

    @property
    def dmax(self) -> int:
        return self.row_vars.shape[1]

    @property
    def cmax(self) -> int:
        return self.var_rows.shape[1]

    @property
    def n_edges(self) -> int:
        return int(self.row_mask.sum())

    @staticmethod
    def build(H: np.ndarray) -> "TannerGraph":
        H = (np.asarray(H) % 2).astype(np.int8)
        m, n = H.shape
        row_deg = H.sum(axis=1).astype(np.int64)
        col_deg = H.sum(axis=0).astype(np.int64)
        dmax = max(1, int(row_deg.max()) if m else 1)
        cmax = max(1, int(col_deg.max()) if n else 1)

        row_vars = np.full((m + 1, dmax), n, dtype=np.int32)
        row_mask = np.zeros((m + 1, dmax), dtype=bool)
        slot_of_edge = np.zeros((m, n), dtype=np.int32)  # dense scratch, host only
        for i in range(m):
            cols = np.nonzero(H[i])[0]
            row_vars[i, : cols.size] = cols
            row_mask[i, : cols.size] = True
            slot_of_edge[i, cols] = np.arange(cols.size)

        var_rows = np.full((n, cmax), m, dtype=np.int32)
        var_slots = np.zeros((n, cmax), dtype=np.int32)
        var_mask = np.zeros((n, cmax), dtype=bool)
        for j in range(n):
            rows = np.nonzero(H[:, j])[0]
            var_rows[j, : rows.size] = rows
            var_slots[j, : rows.size] = slot_of_edge[rows, j]
            var_mask[j, : rows.size] = True

        return TannerGraph(H=H, row_vars=row_vars, row_mask=row_mask,
                           var_rows=var_rows, var_slots=var_slots, var_mask=var_mask)


def layerize(H: np.ndarray, serial: bool = False) -> List[np.ndarray]:
    """Greedy contiguous check-row partition (reference parity:
    simulator.py:212-224, landmine L9 in SURVEY.md §2.7).

    A layer is a maximal contiguous row window in which no column is touched
    twice; `serial=True` forces one row per layer. Matches the reference's
    greedy window arithmetic exactly, including emitting layers as
    half-open contiguous ranges.
    """
    H = np.asarray(H)
    m = H.shape[0]
    layers: List[np.ndarray] = []
    start = 0
    end = 1  # candidate exclusive end of the current window + 1 (ref's mUp)
    while end <= m:
        window_conflict = H[start:end].sum(axis=0).max(initial=0) > 1
        if window_conflict or (serial and end > start + 1):
            layers.append(np.arange(start, end - 1))
            start = end - 1
        else:
            end += 1
    layers.append(np.arange(start, end - 1))
    return layers


@dataclasses.dataclass(frozen=True)
class LayerSchedule:
    """Padded layer-index arrays for jit-friendly layered iteration.

    rows[l, s] is the s-th check row of layer l, padded with m (the decoder's
    dummy message row).
    """

    rows: np.ndarray  # (n_layers, max_layer) int32
    sizes: np.ndarray  # (n_layers,) int32

    @property
    def n_layers(self) -> int:
        return self.rows.shape[0]

    @staticmethod
    def from_layers(layers: Sequence[np.ndarray], m: int) -> "LayerSchedule":
        layers = [np.asarray(l, dtype=np.int32) for l in layers]
        if not layers:
            layers = [np.zeros((0,), dtype=np.int32)]
        # Floor of 8 slots: dummy-row padding is free (row m has no edges).
        max_layer = max(8, max(l.size for l in layers))
        rows = np.full((len(layers), max_layer), m, dtype=np.int32)
        sizes = np.zeros((len(layers),), dtype=np.int32)
        for li, l in enumerate(layers):
            rows[li, : l.size] = l
            sizes[li] = l.size
        return LayerSchedule(rows=rows, sizes=sizes)


def build_layers(H_decode: np.ndarray, schedule: str,
                 H_layerize: Optional[np.ndarray] = None) -> LayerSchedule:
    """Build the check-node schedule for decoding with H_decode.

    schedule: 'F' flooding (one layer, all checks), 'L' layered, 'S' serial
    (reference dispatch: simulator.py:228-236).

    H_layerize: optional different matrix to derive layer boundaries from —
    this reproduces the reference's cross-wired layers (landmine L1,
    simulator.py:233-234 vs :278-282) when compatibility mode is requested.
    By default layers are derived from the matrix actually being decoded
    (the mathematically correct wiring; divergence documented in
    DIVERGENCES.md).
    """
    m = H_decode.shape[0]
    if schedule == "F":
        layers = [np.arange(m)]
    elif schedule in ("L", "S"):
        src = H_decode if H_layerize is None else H_layerize
        layers = layerize(src, serial=(schedule == "S"))
        if H_layerize is not None:
            # Cross-wired layers may index rows beyond H_decode's row count
            # for shape-mismatched codes; clip like the reference effectively
            # does (it would IndexError — it never hits this because library
            # codes are shape-matched; we guard instead).
            layers = [l[l < m] for l in layers]
    else:
        raise ValueError("Unrecognized decoder scheduling option.")
    return LayerSchedule.from_layers(layers, m)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder configuration (reference flag surface: simulator.py:352-365
    plus decoder-internal constants from decoders.py)."""

    dec_type: str = "MS"          # NG | BF | MS | BP
    max_iter: int = 99            # --decIterations default (simulator.py:324)
    schedule: str = "F"           # --decSchedule F|L|S
    osd_order: int = -1           # --OSDorder, -1 disables (simulator.py:326)
    beta: float = 0.75            # MS normalization (decoders.py:116)
    eps: float = 1e-6             # BP tanh clamp; f32-suitable (ref uses 1e-9
                                  # in float64, decoders.py:195 — see DIVERGENCES.md)
    bf_max_iter: int = 50         # BF default (decoders.py:74)
    bf_residual: str = "mod2"     # BF residual semantics: "mod2" (parity —
                                  # the mathematically standard bit-flipping
                                  # residual) | "bool" (reference compat:
                                  # decoders.py:93-95 computes
                                  # bool(H @ e_hat) ^ syndrome, i.e. ANY
                                  # overlap, not overlap parity — a
                                  # genuinely different decoder on rows with
                                  # >= 2 flipped variables; see
                                  # DIVERGENCES.md "BF residual")
    layer_compat: bool = False    # True => reproduce cross-wired layers (L1)
    dtype: str = "float32"        # message dtype
    round1_iters: int = 0         # two-round straggler compaction: first-round
                                  # iteration cap; 0 = auto (12 when
                                  # max_iter > 16), -1 = disable
    compact_cap_frac: float = 0.125  # round-2 capacity as fraction of batch
    impl: str = "auto"            # MS/BP kernel: "auto" | "edge" (bit-exact
                                  # reference-parity path) | "mxu" (incidence-
                                  # matmul path; fp association differs)
                                  # | "seq" (row-sequential, serial schedules)
                                  # | "qc" (Triton circulant-lifted MS kernel,
                                  #   GPU only; ops/ms_qc_triton.py)
    platform: str = "auto"        # execution platform: "auto" | "gpu" | "cpu"
                                  # (platform.resolve_platform); picks the
                                  # decode kernel


@dataclasses.dataclass
class DecodeResult:
    """Batched decode output (device arrays; registered as a JAX pytree).

    e_hat      — (B, n) int8 estimated error
    n_iter     — (B,) int32 iterations used (reference semantics: first
                 iteration index at per-layer convergence + 1, else max_iter)
    converged  — (B,) bool syndrome matched during iteration
    posterior  — (B, n) float32 posterior LLRs (for OSD), or None for BF/NG
    """

    e_hat: object
    n_iter: object
    converged: object
    posterior: object = None


import jax.tree_util as _jtu  # noqa: E402

_jtu.register_pytree_node(
    DecodeResult,
    lambda r: ((r.e_hat, r.n_iter, r.converged, r.posterior), None),
    lambda _, c: DecodeResult(*c),
)
