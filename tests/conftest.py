"""Test configuration: run on a virtual 8-device CPU mesh.

The reference validates its CPU fallback by compiling the same kernels
serially (Makefile:29-33); our analog is running the identical JAX code on
the CPU backend, with 8 virtual devices so sharding tests exercise real
collectives without accelerator hardware.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Entry points (cli.main) point the persistent compile cache at the
# checkout; the suite compiles thousands of throwaway programs, so keep
# them out of it.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    One pytest process compiles hundreds of distinct XLA programs; the
    accumulated in-process JIT state has produced compiler segfaults
    deep into the suite (observed at ~55 tests in).  Modules rarely
    share traces (different shapes/models), so clearing costs little.
    """
    yield
    jax.clear_caches()
