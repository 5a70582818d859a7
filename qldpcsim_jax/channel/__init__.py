"""Native on-device channel: encoder + depolarizing noise + syndrome
extraction.

Replaces the reference's Stim circuit pipeline (simulator.py:43-160 circuit
construction, :196-197 sampling) with pure GF(2) sampling on device — the
semantic insight (SURVEY.md §7 step 2) being that for a CSS code under
depolarizing noise with a maximally mixed logical input, every reported
counter is a function of (errX, errZ, syndromes) alone.
"""

from qldpcsim_jax.channel.depolarizing import (
    sample_depolarizing,
    syndromes_of,
    sample_shot_batch,
)
from qldpcsim_jax.channel.encoder import CSSEncoder

__all__ = [
    "sample_depolarizing",
    "syndromes_of",
    "sample_shot_batch",
    "CSSEncoder",
]
