"""Monte-Carlo engine: per-p shot pipeline, event classification, sweeps.

Reference parity: simulator.simulate_p (simulator.py:167-315) and
simulator.simulate (simulator.py:319-347), rebuilt as a batched on-device
pipeline: channel sampling -> batched decode -> matmul-based classification ->
integer counter reduction.
"""

from qldpcsim_jax.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_jax.engine.montecarlo import SimConfig, simulate, simulate_p
from qldpcsim_jax.engine.results import PPointResult, format_results_table

__all__ = [
    "ClassifierStatic",
    "classify_batch",
    "SimConfig",
    "simulate",
    "simulate_p",
    "PPointResult",
    "format_results_table",
]
