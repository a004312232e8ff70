"""K-means on device.

The reference's model build runs sklearn k-means on the host — the CPU hot
spot of initialisation (`conv_gp/kernels.py:161-164`, `conv_gp/models.py:24-27`,
SURVEY.md §3.2).  Here Lloyd's algorithm is jitted: the assignment step is one
[N, K] distance matmul per iteration.

Init strategies mirror the reference: ``random`` for inducing patches
(`conv_gp/kernels.py:161-162`), ``k-means++`` for the last-layer RBF inducing
points (`conv_gp/models.py:24-27`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from deepcgp_tpu.ops.distances import square_distance as _pairwise_sq


def _plusplus_init(key, X, k):
    N = X.shape[0]
    key, sub = jax.random.split(key)
    first = X[jax.random.randint(sub, (), 0, N)]
    centers = jnp.zeros((k, X.shape[1]), X.dtype).at[0].set(first)
    d2 = jnp.sum((X - first) ** 2, axis=1)

    def body(i, state):
        centers, d2, key = state
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(jnp.sum(d2), 1e-12)
        idx = jax.random.choice(sub, N, p=probs)
        c = X[idx]
        centers = centers.at[i].set(c)
        d2 = jnp.minimum(d2, jnp.sum((X - c) ** 2, axis=1))
        return centers, d2, key

    centers, _, _ = lax.fori_loop(1, k, body, (centers, d2, key))
    return centers


@functools.partial(jax.jit, static_argnames=('k', 'iters', 'init'))
def kmeans(key: jax.Array, X: jax.Array, k: int, iters: int = 50,
           init: str = 'random') -> jax.Array:
    """Cluster rows of X [N, D] into k centers [k, D]."""
    X = jnp.asarray(X)
    N = X.shape[0]
    if init == 'random':
        key, sub = jax.random.split(key)
        idx = jax.random.choice(sub, N, shape=(k,), replace=False)
        centers = X[idx]
    else:
        centers = _plusplus_init(key, X, k)

    def step(_, centers):
        d2 = _pairwise_sq(X, centers)                       # [N, K]
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=X.dtype)   # [N, K]
        counts = jnp.sum(onehot, axis=0)                    # [K]
        sums = onehot.T @ X                                 # [K, D]
        new = sums / jnp.maximum(counts[:, None], 1.0)
        # Keep old center for empty clusters.
        return jnp.where(counts[:, None] > 0, new, centers)

    return lax.fori_loop(0, iters, step, centers)
