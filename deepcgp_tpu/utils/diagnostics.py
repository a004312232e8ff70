"""Numerics diagnostics (SURVEY.md §5.2).

The reference leans on float64-everywhere + jitter for numerical safety and
has no sanitizers.  This rebuild computes in float32, so it ships the
checks instead:

* ``elbo_drift`` — evaluate the same model/batch in f32 and f64 (dtype-
  polymorphic code paths, f64 under ``jax.experimental.enable_x64``) and
  report the relative ELBO drift; the numeric acceptance gate for f32.
* ``param_health`` — non-finite counts per parameter (NatGrad failure
  forensics).
* ``cholesky_health`` — per-layer Kuu Cholesky success under the current
  jitter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def cast_model(model, dtype):
    """Cast every floating pytree leaf of the model to ``dtype``."""
    def cast(leaf):
        if hasattr(leaf, 'dtype') and jnp.issubdtype(leaf.dtype,
                                                     jnp.floating):
            return jnp.asarray(np.asarray(leaf), dtype=dtype)
        return leaf
    return jax.tree_util.tree_map(cast, model)


def elbo_drift(model, X, Y, key, num_samples: int | None = None) -> dict:
    """Relative |ELBO_f32 - ELBO_f64| / |ELBO_f64| on one batch.

    Runs on CPU (f64 needs the process-wide x64 mode).
    Returns {'elbo_f32', 'elbo_f64', 'rel_drift'}.
    """
    cpu = jax.devices('cpu')[0]
    X64 = np.asarray(X, np.float64)
    Y64 = np.asarray(Y)
    if num_samples is not None:
        model = model.replace(num_samples=num_samples)

    with jax.enable_x64(True):
        with jax.default_device(cpu):
            m64 = cast_model(model, jnp.float64)
            e64 = float(m64.elbo(jnp.asarray(X64), jnp.asarray(Y64), key))
            m32 = cast_model(model, jnp.float32)
            e32 = float(m32.elbo(jnp.asarray(X64, np.float32),
                                 jnp.asarray(Y64), key))
    rel = abs(e32 - e64) / max(abs(e64), 1e-12)
    return {'elbo_f32': e32, 'elbo_f64': e64, 'rel_drift': rel}


def param_health(model) -> dict:
    """{pathname: nonfinite count} for every parameter with any NaN/Inf."""
    bad = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n = int((~np.isfinite(arr)).sum())
        if n:
            bad[''.join(str(p) for p in path)] = n
    return bad


def cholesky_health(model) -> list:
    """Per-layer: does chol(Kuu) succeed under the current jitter?
    (JAX signals failure as NaNs, `conv_gp/experiment.py:38-49` analog.)"""
    out = []
    for i, layer in enumerate(model.layers):
        L = layer.precompute().Lm
        out.append({'layer': i,
                    'cholesky_ok': bool(np.all(np.isfinite(np.asarray(L))))})
    return out
