"""Pairwise distance / inner-product helpers.

These replace the squared-distance + matmul blocks inside gpflow's stationary
kernels (the dominant FLOPs of the reference, called from
`conv_gp/kernels.py:46-133` and `conv_gp/layers.py:20-49`).  The
``X @ X2^T`` term is the matmul; the norms fuse into it as epilogues.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def square_distance(X: jax.Array, X2: jax.Array | None = None) -> jax.Array:
    """||x_i - x2_j||^2 for rows of X [..., N, D] and X2 [..., N2, D].

    Uses the expanded form Xs - 2 X X2^T + X2s (one matmul), clamped at
    zero for f32 safety (the reference runs f64 and skips the clamp).

    SELF-grams (X2 is None) run the matmul at Precision.HIGHEST: they become
    Kuu/Kff matrices whose Choleskys must stay positive definite, and a
    DEFAULT-precision f32 matmul (TF32 on the H100) carries ~1e-3 relative
    error — enough to swamp the 1e-3 jitter and NaN the factorization
    whenever the gram is ill-conditioned (observed: dense 1-D inducing points in the
    regression example; Kuu is O(M^2 D) flops, so the exact passes are
    free).  Cross-covariances keep the fast default: they never get
    factorized, and they are where the step's FLOPs live.
    """
    if X2 is None:
        # CENTER the rows before the self-gram: pairwise distances are
        # translation-invariant, so subtracting the (stop-gradient) row
        # mean is exact in both value and gradient — but it shrinks the
        # magnitudes entering the Xs - 2XX^T + X2s cancellation from
        # ||x||^2 to ||x - x_bar||^2.  HIGHEST precision alone cannot do
        # this: it fixes multiply error, not cancellation.  Measured on
        # the 3-layer CIFAR-geometry config (last-layer Z = [384, 250]
        # k-means centroids of ||z||^2 ~ 1e3 features, 47 duplicate rows):
        # uncentered, the f32 gram's min eigenvalue was -7.3e-3 — BELOW
        # the -1e-3 jitter floor, so chol(Kuu) NaN'd the whole training
        # step; centered, the noise drops under the jitter and the
        # factorization holds.  Self-grams are O(M^2 D) — off the hot
        # path — so the extra mean/subtract is free; cross-covariances
        # (the step's FLOPs) stay untouched and unprotected (their noise
        # is absorbed by the conditional's variance clamp, never by a
        # Cholesky).
        X = X - jax.lax.stop_gradient(X.mean(axis=-2, keepdims=True))
        Xs = jnp.sum(jnp.square(X), axis=-1)
        from deepcgp_tpu.ops.linalg import gram_syrk
        cross = gram_syrk(X)    # HIGHEST fwd; one-matmul bwd
        X2s = Xs
    else:
        Xs = jnp.sum(jnp.square(X), axis=-1)
        cross = jnp.matmul(X, jnp.swapaxes(X2, -1, -2))
        X2s = jnp.sum(jnp.square(X2), axis=-1)
    d2 = Xs[..., :, None] - 2.0 * cross + X2s[..., None, :]
    return jnp.maximum(d2, 0.0)
