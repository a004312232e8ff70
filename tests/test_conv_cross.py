"""ops/conv_cross.py oracle: the convolution formulation of the RBF patch
cross-covariance must match the extract-patches + pairwise-kernel path in
f64 (same math, different contraction schedule)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcgp_tpu.models.base_kernels import RBF, ArcCosine
from deepcgp_tpu.models.views import FullView, RandomPartialView
from deepcgp_tpu.ops import conv_cross


@pytest.mark.parametrize('stride,filter_size,C', [(1, 5, 10), (3, 5, 3),
                                                  (2, 3, 1)])
def test_conv_cross_matches_patch_kernel(stride, filter_size, C):
    rng = np.random.RandomState(0)
    H = W = 12
    N, M = 4, 7
    view = FullView(input_size=(H, W), filter_size=filter_size,
                    feature_maps=C, stride=stride)
    X = jnp.asarray(rng.randn(N, H, W, C))
    Z = jnp.asarray(rng.randn(M, view.patch_length))
    kern = RBF.create(variance=2.5, lengthscales=3.0, dtype=jnp.float64)

    ref = kern.K(jnp.swapaxes(view.extract_patches_NPL(X), 0, 1),
                 Z[None])                                   # [P, N, M]
    got = conv_cross.rbf_cross_from_images(
        X, Z, kern.variance, kern.lengthscales, filter_size, stride)
    np.testing.assert_allclose(np.asarray(jnp.swapaxes(got, 0, 1)),
                               np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_conv_cross_gradients_match():
    """d/dZ and d/d(raw params) agree with the extraction path."""
    rng = np.random.RandomState(1)
    view = FullView(input_size=(8, 8), filter_size=3, feature_maps=2,
                    stride=2)
    X = jnp.asarray(rng.randn(3, 8, 8, 2))
    Z0 = jnp.asarray(rng.randn(5, view.patch_length))
    kern = RBF.create(variance=1.5, lengthscales=2.0, dtype=jnp.float64)

    def via_conv(Z, raw_v, raw_l):
        k = kern.replace(raw_variance=raw_v, raw_lengthscales=raw_l)
        return jnp.sum(jnp.sin(conv_cross.rbf_cross_from_images(
            X, Z, k.variance, k.lengthscales, 3, 2)))

    def via_patches(Z, raw_v, raw_l):
        k = kern.replace(raw_variance=raw_v, raw_lengthscales=raw_l)
        P = jnp.swapaxes(view.extract_patches_NPL(X), 0, 1)
        return jnp.sum(jnp.sin(k.K(P, Z[None])))

    args = (Z0, kern.raw_variance, kern.raw_lengthscales)
    g1 = jax.grad(via_conv, argnums=(0, 1, 2))(*args)
    g2 = jax.grad(via_patches, argnums=(0, 1, 2))(*args)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-11)


def test_supports_gating(monkeypatch):
    monkeypatch.setattr(conv_cross, '_ENABLED', True)  # opt-in path
    full = FullView(input_size=(8, 8), filter_size=3, feature_maps=1,
                    stride=1)
    partial = RandomPartialView(input_size=(8, 8), filter_size=3,
                                feature_maps=1, patch_count=4)
    rbf = RBF.create(dtype=jnp.float64)
    rbf_ard = RBF.create(ard_dim=9, dtype=jnp.float64)
    acos = ArcCosine.create(dtype=jnp.float64)
    assert conv_cross.supports(rbf, full)
    assert not conv_cross.supports(rbf_ard, full)   # per-element scales
    assert not conv_cross.supports(acos, full)
    assert not conv_cross.supports(rbf, partial)    # sparse patch subset


def test_layer_and_convkernel_dispatch_equivalence(monkeypatch):
    """End-to-end: ConvLayer.conditional_mean_var and ConvKernel.Kzx_NM give
    identical results whether or not the conv path is eligible (forced by
    swapping the base kernel's lengthscale rank)."""
    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    monkeypatch.setattr(conv_cross, '_ENABLED', True)  # opt-in path

    rng = np.random.RandomState(2)
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=2, batch_size=4)
    X = rng.randn(16, 12, 12, 1)
    Y = rng.randint(0, 10, size=(16, 1))
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    xb = jnp.asarray(X[:4].reshape(4, -1))

    layer = model.layers[0]
    cache = layer.precompute()
    mean1, var1 = layer.conditional_mean_var(cache, xb)

    # Disable the conv path by making the lengthscale ARD-shaped with equal
    # entries (same math, fails the scalar gate).
    L = layer.view.patch_length
    kern_ard = layer.base_kernel.replace(
        raw_lengthscales=jnp.broadcast_to(
            layer.base_kernel.raw_lengthscales, (L,)))
    layer2 = layer.replace(base_kernel=kern_ard)
    mean2, var2 = layer2.conditional_mean_var(layer2.precompute(), xb)
    np.testing.assert_allclose(np.asarray(mean1), np.asarray(mean2),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(var1), np.asarray(var2),
                               rtol=1e-9, atol=1e-11)
