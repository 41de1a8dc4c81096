"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Behaviour on the GPU is exercised by ``chip_smoke.py`` on the card and by
tests marked ``gpu``, which skip without one; unit tests validate numerics
and sharding on host CPU.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


# XLA:CPU JIT leaves ~80 KB anonymous mappings behind per compiled
# executable (code pages + arena chunks, held by the live compilation
# caches). A full-suite run accumulates past the kernel's default
# vm.max_map_count (65530); the next mmap inside the compiler then fails
# and XLA segfaults — reproducibly ~250 tests in, at whatever test
# compiles next. jax.clear_caches() releases the mappings (measured:
# 3660 -> 569), so shed the caches whenever the process nears the limit;
# the handful of recompiles this forces is noise next to a dead suite.
_MAPS_SOFT_LIMIT = 30000


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as fh:
            return sum(1 for _ in fh)
    except OSError:  # non-Linux: the kernel limit doesn't exist either
        return 0


@pytest.fixture
def quant_mm_f32():
    """Quantized matmuls in exact f32 mode for the test (bf16 is the
    serving default on every backend)."""
    from asr_jax.ops.quant_matmul import set_quant_config

    set_quant_config(mm="f32")
    yield
    set_quant_config(mm=None)


def pytest_runtest_teardown(item, nextitem):
    if _n_maps() > _MAPS_SOFT_LIMIT:
        import gc

        jax.clear_caches()
        gc.collect()
