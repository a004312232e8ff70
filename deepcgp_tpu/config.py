"""Global numeric configuration.

The reference (kekeblom/DeepCGP) runs everything in float64 with an absolute
jitter of 1e-3 (reference `gpflowrc:6-11`).  Accelerator matmul units are
fastest in float32 (or lower), so the rebuild defaults to float32 with the
same absolute jitter; float64 remains available for validation runs (tests
enable ``jax_enable_x64`` and pass f64 arrays through the same code paths).

Everything in this library is dtype-polymorphic: compute follows the dtype of
the parameters, so a single code path serves both the fast f32 mode and
the f64 oracle-parity mode.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp


@dataclasses.dataclass
class Settings:
    # Absolute diagonal jitter added to every Kuu (reference gpflowrc:10).
    jitter: float = 1e-3
    # Default parameter/compute dtype.
    float_type: type = jnp.float32
    # Lower bound of the positive-parameter bijector (gpflow 1.x Log1pe shift).
    positive_minimum: float = 1e-6
    # Gauss-Hermite points for the robust-max likelihood (gpflow default).
    num_gauss_hermite_points: int = 20


def _env_flag(name: str) -> bool:
    return os.environ.get(name, '').strip().lower() in ('1', 'true', 'yes',
                                                        'on')


def _apply_env_overrides(s: Settings) -> Settings:
    """Environment overrides — the rebuild's analog of the reference's
    ``gpflowrc`` file (float type / jitter / threads, `gpflowrc:6-25`):

    DEEPCGP_JITTER=<float>    absolute Kuu jitter (default 1e-3)
    DEEPCGP_FLOAT64=1         default dtype f64 (also enables jax x64 mode)
    """
    if os.environ.get('DEEPCGP_JITTER'):
        s.jitter = float(os.environ['DEEPCGP_JITTER'])
    if _env_flag('DEEPCGP_FLOAT64'):
        import jax
        jax.config.update('jax_enable_x64', True)
        s.float_type = jnp.float64
    return s


settings = _apply_env_overrides(Settings())
