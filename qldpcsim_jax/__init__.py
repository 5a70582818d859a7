"""qldpcsim_jax — quantum-LDPC Monte Carlo engine in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
simulator qLDPCsim (see /root/reference): Monte-Carlo estimation of the quantum
block error rate (qBLER) of CSS codes under depolarizing noise, with

  * a native on-device GF(2) encoder + depolarizing channel + syndrome extractor
    (replacing the reference's Stim circuit simulation),
  * batched BP / normalized-min-sum / bit-flipping / naive-greedy decoders with
    flooding / layered / serial schedules and GF(2) OSD post-processing,
  * shot- and p-point-sharding over a `jax.sharding.Mesh` with psum-reduced
    counters, and
  * a Pallas kernel (Triton route) for min-sum decoding of circulant-lifted
    codes on NVIDIA GPUs.

Public surface mirrors the reference package layout (reference:
qLDPCsim/__init__.py:1-2) while fixing its `PMClibrary` typo.
"""

from qldpcsim_jax.version import __version__

__all__ = [
    "__version__",
    "codes",
    "gf2",
    "channel",
    "decoders",
    "engine",
    "parallel",
    "ops",
    "utils",
    "simulate",
    "simulate_p",
]


def __getattr__(name):
    # Lazy imports keep `import qldpcsim_jax` cheap (no jax import on startup).
    import importlib

    if name in ("codes", "gf2", "channel", "decoders", "engine", "parallel", "ops", "utils"):
        return importlib.import_module(f"qldpcsim_jax.{name}")
    if name in ("simulate", "simulate_p"):
        mod = importlib.import_module("qldpcsim_jax.engine.montecarlo")
        return getattr(mod, name)
    raise AttributeError(f"module 'qldpcsim_jax' has no attribute {name!r}")
