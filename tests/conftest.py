"""Test configuration: run on CPU with 8 virtual devices (multi-chip sharding
tests) and float64 enabled (oracle-parity tests drive the same code paths in
f64; the library itself defaults to f32).

The platform is forced through jax.config, which wins over an inherited
JAX_PLATFORMS.  DEEPCGP_TEST_PLATFORM=gpu runs the tests on the card instead
(``python -m pytest -m gpu tests/``, as chip_smoke.py does); tests marked
``gpu`` skip from inside their fixture when there is no card.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

_platform = os.environ.get("DEEPCGP_TEST_PLATFORM", "cpu")
# 'gpu' is JAX's alias for every GPU backend: name the installed one, and
# keep the CPU for float64 references.
jax.config.update("jax_platforms",
                  {"gpu": "cuda,cpu"}.get(_platform, _platform))
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU.  Without one the test skips, unless the run asked for
    the GPU (DEEPCGP_TEST_PLATFORM=gpu), where a missing card fails it."""
    missing = pytest.fail if _platform == "gpu" else pytest.skip
    try:
        devices = jax.devices()
    except RuntimeError as e:
        missing(f"no GPU backend: {e}")
    if devices[0].platform != "gpu":
        missing(f"needs a GPU; JAX has {devices[0].platform}")
    return devices[0]
