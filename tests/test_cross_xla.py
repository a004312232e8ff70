"""The last layer's cross-covariance path as the training step runs it:
``Kzx_NM_and_Kdiag`` under ``jax.checkpoint`` (``models/layers.py``), for
both patch-sum kernel classes, against the float64 oracle — values at the
flagship, digits and stride/dilation geometries, gradients w.r.t. the
image, the inducing patches and the patch weights against central finite
differences of the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from deepcgp_tpu.models.base_kernels import RBF
from deepcgp_tpu.models.conv_kernels import AdditivePatchKernel, ConvKernel
from deepcgp_tpu.models.layers import _svgp_kuf_kdiag
from deepcgp_tpu.models.views import FullView

GEOMS = [
    # (H, W, C, f, s, d, M) — flagship last layer, digits last layer,
    # stride/dilation coverage.
    (10, 10, 10, 5, 1, 1, 24),
    (8, 8, 1, 3, 1, 1, 16),
    (9, 11, 3, 3, 2, 1, 10),
    (12, 12, 2, 3, 1, 2, 12),
]
VARIANCE, LENGTHSCALE = 1.3, 0.9


def _setup(H, W, C, f, s, d, M, cls, seed=0):
    rng = np.random.RandomState(seed)
    view = FullView(input_size=(H, W), filter_size=f, feature_maps=C,
                    stride=s, dilation=d)
    base = RBF.create(variance=VARIANCE, lengthscales=LENGTHSCALE,
                      dtype=jnp.float64)
    w = rng.rand(view.patch_count) + 0.5
    k = cls.create(base, view, patch_weights=w, dtype=jnp.float64)
    X = rng.randn(6, H * W * C)
    Z = rng.randn(M, view.patch_length)
    return k, X, Z, w


def _oracle(cls, view, X, Z, w):
    """(Kzx [N, M], Kdiag [N]) from literal patch sums
    (`conv_gp/kernels.py:15-137`)."""
    H, W = view.input_size
    patches = oracle.extract_patches(
        X.reshape(X.shape[0], H, W, view.feature_maps), view.filter_size,
        view.stride, view.dilation)                              # [N, P, L]
    P = patches.shape[1]
    kzx = np.stack([
        sum(w[p] * oracle.rbf_K(VARIANCE, LENGTHSCALE, pn[p:p + 1], Z)[0]
            for p in range(P)) / P for pn in patches])
    if cls is ConvKernel:
        kd = np.array([np.sum(np.outer(w, w) * oracle.rbf_K(
            VARIANCE, LENGTHSCALE, pn)) / P ** 2 for pn in patches])
    else:
        kd = np.full(X.shape[0], VARIANCE * np.mean(w))
    return kzx, kd


def _remat(kernel, Z, X):
    return jax.checkpoint(_svgp_kuf_kdiag)(kernel, Z, X)


@pytest.mark.parametrize('cls', [ConvKernel, AdditivePatchKernel])
@pytest.mark.parametrize('H,W,C,f,s,d,M', GEOMS)
def test_kzx_and_kdiag_matches_oracle(H, W, C, f, s, d, M, cls):
    k, X, Z, w = _setup(H, W, C, f, s, d, M, cls)
    kzx, kd = _remat(k, jnp.asarray(Z), jnp.asarray(X))
    want_kzx, want_kd = _oracle(cls, k.view, X, Z, w)
    np.testing.assert_allclose(np.asarray(kzx), want_kzx, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(kd), want_kd, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize('cls', [ConvKernel, AdditivePatchKernel])
@pytest.mark.parametrize('H,W,C,f,s,d,M', GEOMS[:2])
def test_kzx_and_kdiag_grad_matches_oracle(H, W, C, f, s, d, M, cls):
    """Directional derivative of a random linear functional of (Kzx, Kdiag)
    along a random direction in (image, Z, patch weights)."""
    k, X, Z, w = _setup(H, W, C, f, s, d, M, cls, seed=1)
    rng = np.random.RandomState(2)
    ckzx, ckd = rng.randn(X.shape[0], M), rng.randn(X.shape[0])
    dX, dZ, dw = rng.randn(*X.shape), rng.randn(*Z.shape), rng.randn(*w.shape)

    def loss(kernel, Z_, X_):
        kzx, kd = _remat(kernel, Z_, X_)
        return jnp.sum(kzx * ckzx) + jnp.sum(kd * ckd)

    gk, gZ, gX = jax.grad(loss, argnums=(0, 1, 2))(
        k, jnp.asarray(Z), jnp.asarray(X))
    got = (np.vdot(gX, dX) + np.vdot(gZ, dZ)
           + np.vdot(gk.patch_weights, dw))

    def oracle_loss(t):
        kzx, kd = _oracle(cls, k.view, X + t * dX, Z + t * dZ, w + t * dw)
        return np.sum(kzx * ckzx) + np.sum(kd * ckd)

    h = 1e-5
    want = (oracle_loss(h) - oracle_loss(-h)) / (2 * h)
    np.testing.assert_allclose(got, want, rtol=1e-6)
