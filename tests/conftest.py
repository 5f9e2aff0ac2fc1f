"""Test harness setup: run JAX on a virtual 8-device CPU mesh with x64 so
the f64 parity path is exact, per SURVEY §4 (multi-device sharding is
validated without accelerators via xla_force_host_platform_device_count).
The platform is set before any backend initialization from
JAX_PLATFORMS, cpu unless it is already set, and exported so CLI
subprocesses follow it.

Tests that need a GPU carry the `gpu` marker; the `gpu_device` fixture
skips them where JAX finds no GPU. On a GPU host run them with
`JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/` (the CPU stays
the default backend, the GPU is reached explicitly).
"""

import os

import pytest

# the persistent v4 plan cache would short-circuit rebuild-twice
# differential tests (and write to ~/.cache from CI); the dedicated
# cache tests opt back in with a tmp dir
os.environ.setdefault("OARFISH_PLAN_CACHE", "0")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX finds none"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip. Decided when the test runs,
    never at import or collection."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend in this process")
