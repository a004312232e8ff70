"""Model-inspection utilities — the library form of the reference's
analysis notebooks (`notebooks/Inspect.ipynb`, `notebooks/convgp MNIST.ipynb`,
`notebooks/fm_experiment.ipynb`):

* per-layer feature extraction via ``DGP.propagate`` (the notebooks call
  ``model.propagate(X, S)`` for UMAP feature maps);
* inducing-patch tiling (the MNIST notebook's inducing-point grids);
* 2-D embeddings of inducing patches against data patches (UMAP when the
  optional dependency is importable, PCA fallback otherwise);
* noise-robustness evaluation (accuracy under additive input noise,
  `Inspect.ipynb`'s robustness figure).

Everything returns plain numpy so the results drop into matplotlib or any
downstream analysis without device round-trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def layer_features(model, X: np.ndarray, key: jax.Array, num_samples: int = 1):
    """Per-layer (samples, means, variances) for flattened inputs X [N, D].

    Returns three lists of numpy arrays, one entry per layer with shapes
    [S, N, O_l] — the data behind the notebooks' per-layer UMAP plots."""
    res = model.propagate(jnp.asarray(X), key, num_samples)
    to_np = lambda xs: [np.asarray(x) for x in xs]
    return to_np(res.samples), to_np(res.means), to_np(res.variances)


def inducing_patches(layer) -> np.ndarray:
    """A layer's inducing patches as [M, fh, fw, C] images."""
    Z = np.asarray(layer.Z)
    view = getattr(layer, 'view', None) or getattr(layer.kernel, 'view', None)
    if view is None:
        raise ValueError("layer has no patch view (plain-RBF last layer)")
    fh, fw = view.patch_shape
    return Z.reshape(Z.shape[0], fh, fw, view.feature_maps)


def inducing_patch_grid(layer, cols: int = 16, pad: int = 1) -> np.ndarray:
    """Tile a layer's inducing patches into one [H, W] grayscale image
    (channel-averaged), like the reference MNIST notebook's tiling."""
    patches = inducing_patches(layer).mean(axis=-1)  # [M, fh, fw]
    M, fh, fw = patches.shape
    rows = int(np.ceil(M / cols))
    lo, hi = patches.min(), patches.max()
    patches = (patches - lo) / (hi - lo + 1e-12)
    grid = np.zeros((rows * (fh + pad) - pad, cols * (fw + pad) - pad))
    for m in range(M):
        r, c = divmod(m, cols)
        grid[r * (fh + pad):r * (fh + pad) + fh,
             c * (fw + pad):c * (fw + pad) + fw] = patches[m]
    return grid


def _pca_2d(X: np.ndarray) -> np.ndarray:
    Xc = X - X.mean(axis=0)
    _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
    return Xc @ Vt[:2].T


def patch_embedding(layer, NHWC_X: np.ndarray, max_data_patches: int = 5000,
                    seed: int = 0):
    """2-D embedding of inducing patches together with data patches.

    Returns (emb_inducing [M, 2], emb_data [n, 2]).  Uses UMAP when
    installed (the notebooks' choice); otherwise joint PCA."""
    from deepcgp_tpu.models.inducing import sample_patches
    view = getattr(layer, 'view', None) or \
        getattr(getattr(layer, 'kernel', None), 'view', None)
    if view is None:
        raise ValueError("layer has no patch view (plain-RBF last layer)")
    Z = np.asarray(layer.Z)
    data = np.asarray(sample_patches(
        jax.random.PRNGKey(seed), jnp.asarray(NHWC_X),
        min(max_data_patches, NHWC_X.shape[0] * 4), view.filter_size))
    joint = np.concatenate([Z, data], axis=0)
    try:
        import umap  # optional dependency (umap-learn)
        emb = umap.UMAP(n_components=2).fit_transform(joint)
    except ImportError:
        # Without umap-learn the embeddings reproduced from
        # `notebooks/Inspect.ipynb` use joint PCA as the documented
        # substitute (the conditional import prefers umap — pinned by
        # test_inspect.py::test_patch_embedding_uses_umap...).
        import warnings
        warnings.warn("umap-learn is not installed; patch embedding falls "
                      "back to a 2-D PCA projection")
        emb = _pca_2d(joint)
    return emb[:Z.shape[0]], emb[Z.shape[0]:]


def noise_robustness(model, X_test: np.ndarray, Y_test: np.ndarray,
                     key: jax.Array, noise_levels=(0.0, 0.25, 0.5, 1.0),
                     batch_size: int = 32, num_samples: int = 5,
                     max_points: int = 512):
    """Test accuracy under additive Gaussian input noise
    (`Inspect.ipynb`'s robustness sweep).  Returns {sigma: accuracy}."""
    from deepcgp_tpu.training import trainer
    X = X_test.reshape(X_test.shape[0], -1)[:max_points]
    Y = Y_test[:max_points]
    out = {}
    for sigma in noise_levels:
        key, k_noise, k_eval = jax.random.split(key, 3)
        noise = sigma * np.asarray(
            jax.random.normal(k_noise, X.shape, jnp.float32))
        out[float(sigma)] = trainer.accuracy(
            model, (X + noise).astype(X.dtype), Y, k_eval,
            batch_size=batch_size, num_samples=num_samples)
    return out
