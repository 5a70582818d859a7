"""Auxiliary subsystems: checkpoint/resume, profiling, config helpers
(SURVEY.md §5 — all absent in the reference; built in here)."""

from qldpcsim_jax.utils.checkpoint import CheckpointStore
from qldpcsim_jax.utils.profiling import Timer, ThroughputMeter, trace_context

__all__ = ["CheckpointStore", "Timer", "ThroughputMeter", "trace_context"]
