"""Test configuration: JAX on a virtual 8-device CPU mesh unless
JAX_PLATFORMS says otherwise, so multi-device sharding paths run without
accelerators (SURVEY.md §4: simulated sharding via
xla_force_host_platform_device_count).

Tests marked `gpu` need an NVIDIA GPU: the `gpu` fixture skips them when
JAX finds none.  Run them on a GPU host with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# no JAX_ENABLE_X64: the package computes in 32-bit types (f32/i32 with
# in-kernel renormalization where the C reference used double)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {dev.platform})")
    return dev
