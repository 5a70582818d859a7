"""Test configuration: run everything on a virtual 8-device CPU mesh so the
sharded paths are exercised without accelerators (SURVEY.md §4.4).

JAX_PLATFORMS, where set, chooses the backend (the chip-marked tests run
with `JAX_PLATFORMS=cuda,cpu` on the card); otherwise the CPU is pinned
before any backend initializes.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device. Tests marked `chip` take this fixture, so they
    skip, with the reason, wherever JAX finds no GPU."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda,cpu python "
                    "-m pytest -m chip tests/` on the card")
    return devs[0]


@pytest.fixture
def eight_devices():
    """Skip unless the session has 8 devices (the virtual CPU mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
