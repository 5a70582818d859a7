"""Execution platform of a shot pipeline, and the decode kernel it gets.

One decision, made from the devices a pipeline runs on: `"gpu"` or `"cpu"`.
Any other platform is refused rather than guessed at, so a pipeline never
silently takes a path that was not built for its device.
"""

from __future__ import annotations

from typing import Iterable, Optional

PLATFORMS = ("gpu", "cpu")


def platform_of(devices: Iterable) -> str:
    """Platform shared by `devices` ("gpu" or "cpu"); raises ValueError for
    a mixed set or any other platform."""
    plats = {str(d.platform).lower() for d in devices}
    if len(plats) != 1:
        raise ValueError(f"pipeline devices span platforms {sorted(plats)}; "
                         "expected one of gpu or cpu")
    (plat,) = plats
    if plat not in PLATFORMS:
        raise ValueError(f"unsupported execution platform {plat!r}: "
                         "expected gpu or cpu")
    return plat


def resolve_platform(platform: str = "auto", devices: Optional[Iterable] = None) -> str:
    """An explicit "gpu"/"cpu" stands; "auto" reads `devices` (default: the
    session's default device)."""
    if platform in PLATFORMS:
        return platform
    if platform != "auto":
        raise ValueError(f"platform must be auto, gpu or cpu, got {platform!r}")
    if devices is None:
        import jax

        devices = jax.devices()[:1]
    return platform_of(devices)


def qc_kernel_applies(platform: str, impl: str, supported: bool) -> bool:
    """Whether MS decoding uses the Triton QC kernel (ops/ms_qc_triton.py).

    `supported` is the kernel's own structural test (circulant-lifted H with
    a power-of-two lift, schedule F or block-row-aligned L). `impl="qc"`
    forces it and fails where it cannot run; "auto" picks it on the GPU
    only. The kernel is compiled for the card and has no CPU path.
    """
    if impl == "qc":
        if platform != "gpu":
            raise ValueError("impl='qc' is a GPU kernel; this pipeline runs "
                             f"on {platform}")
        if not supported:
            raise ValueError("qc kernel needs MS, schedule F or block-row-"
                             "aligned L, and a circulant-lifted H with a "
                             "power-of-two lift size")
        return True
    return impl == "auto" and platform == "gpu" and supported
