"""Inducing-feature initialisation.

Rebuild of ``PatchInducingFeatures.from_images`` + helpers
(`conv_gp/kernels.py:139-170`): sample 100*M random patches from random
training images, then k-means (random init) with M clusters.  The reference
does this on the host with sklearn (init-time CPU hot spot, SURVEY.md §3.2);
here sampling and clustering are both on-device and jitted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.ops.kmeans import kmeans

SAMPLES_PER_INDUCING_POINT = 100  # reference kernels.py:146


def sample_patches(key: jax.Array, NHWC_X: jax.Array, count: int,
                   patch_size: int) -> jax.Array:
    """``count`` random patches, one from a random image each
    (`conv_gp/kernels.py:139-159`).  Offsets are drawn from
    [0, size - patch_size) — the reference's (exclusive) range."""
    N, H, W, C = NHWC_X.shape
    k1, k2, k3 = jax.random.split(key, 3)
    img_idx = np.asarray(jax.random.randint(k1, (count,), 0, N))
    ys = np.asarray(jax.random.randint(k2, (count,), 0, H - patch_size))
    xs = np.asarray(jax.random.randint(k3, (count,), 0, W - patch_size))

    # Host-side gather: one-shot init-time work on arrays already on the
    # host (the reference also does it there, kernels.py:139-159).
    # Runs in the native C++ pipeline when built, numpy otherwise.
    from deepcgp_tpu import native
    patches = native.sample_patches(np.asarray(NHWC_X), img_idx, ys, xs,
                                    patch_size)
    return jnp.asarray(patches, dtype=NHWC_X.dtype)


def patch_inducing_points(key: jax.Array, NHWC_X: jax.Array, M: int,
                          patch_size: int, *, kmeans_iters: int = 50
                          ) -> jax.Array:
    """[M, patch_size^2 * C] initial inducing patches."""
    k1, k2 = jax.random.split(key)
    patches = sample_patches(k1, NHWC_X, M * SAMPLES_PER_INDUCING_POINT,
                             patch_size)
    return kmeans(k2, patches, M, iters=kmeans_iters, init='random')


def inducing_points_from_data(key: jax.Array, X: jax.Array, M: int,
                              *, kmeans_iters: int = 50) -> jax.Array:
    """Last-layer RBF inducing init: k-means++ over (flattened) data rows
    (`conv_gp/models.py:24-27`)."""
    return kmeans(key, X, M, iters=kmeans_iters, init='k-means++')
