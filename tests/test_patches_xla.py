"""Slice-form patch extraction (``ops/patches.py``), the only im2col the
hot path runs: values against a numpy im2col, the VJP against a numpy
col2im, and the native-order variant as a column permutation of it, across
the geometries of the shipped configs (flagship last layer, MNIST and CIFAR
first layers) plus odd sizes, strides and dilations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcgp_tpu.ops.patches import (extract_patches, extract_patches_native,
                                     native_perm, out_size)

SHAPES = [
    (10, 10, 10, 5, 1, 1),   # flagship last layer
    (28, 28, 1, 5, 2, 1),    # MNIST hidden conv
    (9, 11, 3, 3, 2, 2),     # odd sizes, stride+dilation
    (32, 32, 3, 5, 3, 1),    # CIFAR first layer
    (6, 6, 1, 3, 1, 2),      # dilation-only
]


def _im2col(x, f, s, d):
    """[N, H, W, C] -> [N, P, L], TF ordering ((fh, fw, C) fastest-last),
    with explicit loops over output positions."""
    N, H, W, C = x.shape
    Ho, Wo = out_size(H, f, s, d), out_size(W, f, s, d)
    out = np.zeros((N, Ho * Wo, f * f * C))
    for i in range(Ho):
        for j in range(Wo):
            win = x[:, i * s:i * s + (f - 1) * d + 1:d,
                    j * s:j * s + (f - 1) * d + 1:d, :]
            out[:, i * Wo + j] = win.reshape(N, -1)
    return out


def _col2im(g, shape, f, s, d):
    """Adjoint of :func:`_im2col`: scatter-add every patch back."""
    N, H, W, C = shape
    Ho, Wo = out_size(H, f, s, d), out_size(W, f, s, d)
    out = np.zeros(shape)
    for i in range(Ho):
        for j in range(Wo):
            out[:, i * s:i * s + (f - 1) * d + 1:d,
                j * s:j * s + (f - 1) * d + 1:d, :] += \
                g[:, i * Wo + j].reshape(N, f, f, C)
    return out


@pytest.mark.parametrize("H,W,C,f,s,d", SHAPES)
def test_extract_patches_matches_numpy_im2col(H, W, C, f, s, d):
    x = np.random.RandomState(0).randn(7, H, W, C)
    got = extract_patches(jnp.asarray(x), f, s, d)
    want = _im2col(x, f, s, d)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("H,W,C,f,s,d", SHAPES[:3])
def test_extract_patches_vjp_matches_numpy_col2im(H, W, C, f, s, d):
    rng = np.random.RandomState(2)
    x = rng.randn(5, H, W, C)
    g = rng.randn(*_im2col(x, f, s, d).shape)
    got = jax.grad(lambda im: jnp.vdot(extract_patches(im, f, s, d),
                                       jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), _col2im(g, x.shape, f, s, d),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("H,W,C,f,s,d", SHAPES[:3])
def test_native_order_is_column_permutation(H, W, C, f, s, d):
    x = jnp.asarray(np.random.RandomState(1).randn(4, H, W, C))
    tf_order = np.asarray(extract_patches(x, f, s, d))
    native = np.asarray(extract_patches_native(x, f, s, d))
    np.testing.assert_allclose(native, tf_order[..., native_perm(f, C)],
                               rtol=1e-12, atol=1e-12)
