"""Test configuration: 8 virtual CPU devices, x64, the compile cache, and the
`gpu` marker.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`). Multi-chip sharding tests
use --xla_force_host_platform_device_count so the same shard_map code path
runs without several cards. Tests marked `gpu` need a CUDA device; the
`gpu_device` fixture skips them elsewhere (decided at run time, never at
import, so every xdist worker collects the same tests).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

from krepp_tpu import configure  # noqa: E402

# x64 + the persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the
# checkout's .jax_cache): the suite's cost is dominated by CPU jit compiles of
# the fused engine programs, and caching them across runs keeps it short
configure()


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
