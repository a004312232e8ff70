"""deepcgp_tpu: a deep convolutional Gaussian process framework in JAX.

Functional JAX rebuild of the capabilities of kekeblom/DeepCGP (see
SURVEY.md): sparse variational conv-GP layers, doubly-stochastic DGP
training, robust-max multiclass likelihood, experiment/CLI layer, and
mesh-sharded multi-device execution.
"""

from __future__ import annotations

import os

# Fixed in-checkout cache directory: the path is part of the cache key, so
# it must not depend on a temp name, a process id or the time.
DEFAULT_COMPILATION_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '.jax_cache')


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's
    ``.jax_cache``."""
    return (os.environ.get('JAX_COMPILATION_CACHE_DIR')
            or DEFAULT_COMPILATION_CACHE_DIR)


def _enable_persistent_compilation_cache() -> None:
    """Keep compiled programs across processes, so model builds and repeat
    runs skip recompilation.  JAX itself reads
    ``$JAX_COMPILATION_CACHE_DIR``; only when that is unset does this set
    the directory.  Opt out with DEEPCGP_NO_COMPILATION_CACHE=1."""
    if os.environ.get('DEEPCGP_NO_COMPILATION_CACHE'):
        return
    import jax
    if (not os.environ.get('JAX_COMPILATION_CACHE_DIR')
            and jax.config.jax_compilation_cache_dir is None):
        jax.config.update('jax_compilation_cache_dir',
                          DEFAULT_COMPILATION_CACHE_DIR)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)


_enable_persistent_compilation_cache()
