"""GPU kernels (Pallas, Triton route) and the static structure they exploit."""

from qldpcsim_jax.ops.qc import QCStructure, detect_qc

__all__ = ["QCStructure", "detect_qc"]
