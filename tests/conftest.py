"""Test configuration: force an 8-device virtual CPU mesh before JAX loads.

This is the TPU-idiomatic analogue of a fake distributed backend (SURVEY.md §4):
all sharding/pjit tests run against 8 virtual CPU devices.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the shell may preset a TPU platform
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may already be imported by a pytest plugin; the backend is still
# uninitialized at conftest time, so the config route also works.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# Parity tests compare fp32 math against torch; JAX's default matmul
# precision is reduced (bf16 passes), so force full fp32 for tests.
jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel on the card; skips where there is no CUDA device"
    )
