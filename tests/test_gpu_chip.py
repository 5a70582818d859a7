"""Checks that need an NVIDIA GPU: the Triton kernel as compiled for the
card, and the engine on the card against the CPU backend. Each takes the
`gpu` fixture, so it skips, with the reason, where JAX finds no GPU. On the
card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/

`python chip_smoke.py` runs the same checks (its phases b-e) at full size.
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.chip


def test_channel_bit_exact_vs_cpu(gpu):
    r = chip_smoke.phase_channel(gpu, jax.devices("cpu")[0], n_tiles=16)
    assert r["ok"], r


def test_qc_kernel_compiled_agrees_with_edge(gpu):
    """The Triton kernel at the flagship's widths (LP118_0, B=4096): converged
    shots syndrome-consistent and in agreement with the edge oracle."""
    r = chip_smoke.phase_decoder(gpu, codes=("lp118_0",), impls=("qc",))
    assert r["ok"], r


def test_small_code_engine_matches_cpu(gpu):
    """Shor BP flooding and Steane MS layered through simulate_p on the card
    agree with the CPU backend within 4 sigma (same tile stream)."""
    with jax.default_device(gpu):
        r = chip_smoke.phase_baselines(specs=chip_smoke.BASELINES[:2])
    assert r["ok"], r
