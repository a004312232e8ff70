"""RBF patch cross-covariance as a convolution (OPT-IN alternative path).

The patch-sum kernels evaluate k(x[p], z_m) for every patch position p of an
image (reference `conv_gp/kernels.py:117-133` via `views.py:34-38`
tf.extract_image_patches + matmul).  For an RBF base kernel with a SCALAR
lengthscale the whole cross-covariance factors through the image directly:

    ||patch_p(x)/l - z_m/l||^2
        = conv(x^2/l^2, ones)[p] - 2 conv(x/l, z_m/l)[p] + ||z_m/l||^2

so the dominant contraction becomes a convolution with the (scaled)
inducing patches as its filters and the im2col tensor never reaches HBM.
This won round 2 (the last layer then ran vmapped over the S samples and
materialized a patch tensor per sample); in round 3 the S axis is folded
into the batch and extraction is slice-based and shared with Kdiag, after
which the image-layout convs measured slower than plain patch matmuls on
earlier hardware — so the default path is extraction + matmul and this
module is enabled only by ``DEEPCGP_CONV_CROSS=1`` (see :func:`supports`).

Patch/filter element ordering is the TF one the rest of the library uses:
Z rows are (fh, fw, C) row-major, so Z.reshape(M, fh, fw, C) -> HWIO.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_DN = ('NHWC', 'HWIO', 'NHWC')


def rbf_cross_from_images(NHWC_X: jax.Array, Z: jax.Array, variance,
                          lengthscale, filter_size: int, stride: int = 1,
                          dilation: int = 1) -> jax.Array:
    """[N, P, M] = variance * exp(-0.5 ||patch_p(x_n) - z_m||^2 / l^2).

    ``Z`` is [M, L] with L = fh*fw*C in (fh, fw, C) order; ``lengthscale``
    must be scalar (ARD patch elements cannot be folded into an image
    rescale because patches overlap).
    """
    N, H, W, C = NHWC_X.shape
    M, L = Z.shape
    f = filter_size
    assert L == f * f * C, (L, f, C)

    X = NHWC_X / lengthscale
    Zs = Z / lengthscale
    Zf = jnp.transpose(Zs.reshape(M, f, f, C), (1, 2, 3, 0))  # HWIO

    cross = lax.conv_general_dilated(
        X, Zf, (stride, stride), 'VALID',
        rhs_dilation=(dilation, dilation), dimension_numbers=_DN)
    # ||patch||^2 as a SEPARABLE box sum at HIGHEST precision: channel-sum
    # X^2 elementwise (exact f32), then two rank-1 ones-convs over H and W.
    # Exactness: the old extraction path computed patch norms elementwise in
    # f32 and this replaces it, so no bf16 error is stacked on top of the
    # cross term's.  The separable form does f+f MACs per output instead of
    # the dense ones-conv's f*f*C.
    xsq = jnp.sum(X * X, axis=3, keepdims=True)                # [N, H, W, 1]
    ones_h = jnp.ones((f, 1, 1, 1), X.dtype)
    ones_w = jnp.ones((1, f, 1, 1), X.dtype)
    xn = lax.conv_general_dilated(
        xsq, ones_h, (stride, 1), 'VALID',
        rhs_dilation=(dilation, 1), dimension_numbers=_DN,
        precision=lax.Precision.HIGHEST)
    xn = lax.conv_general_dilated(
        xn, ones_w, (1, stride), 'VALID',
        rhs_dilation=(1, dilation), dimension_numbers=_DN,
        precision=lax.Precision.HIGHEST)
    zn = jnp.sum(Zs * Zs, axis=1)                              # [M]

    d2 = jnp.maximum(xn - 2.0 * cross + zn, 0.0)               # [N,Ho,Wo,M]
    K = variance * jnp.exp(-0.5 * d2)
    return K.reshape(N, -1, M)                                 # [N, P, M]


import os

_ENABLED = bool(os.environ.get('DEEPCGP_CONV_CROSS'))


def supports(base_kernel, view) -> bool:
    """OPT-IN (DEEPCGP_CONV_CROSS=1); the default cross-covariance path is
    patch extraction + matmul.

    History: the conv form won while the last layer ran under vmap-over-S
    and extraction materialized an im2col tensor per sample.  Once S was
    folded into the batch axis and Kdiag switched to slice extraction, the
    patches are materialized ONCE and shared, and the patch matmul won.
    Whether that holds on the H100 is open (ROADMAP C3).  Applies only to
    scalar-lengthscale RBF over a dense FullView."""
    from deepcgp_tpu.models.base_kernels import RBF
    from deepcgp_tpu.models.views import FullView
    return (_ENABLED
            and isinstance(base_kernel, RBF)
            and jnp.ndim(base_kernel.raw_lengthscales) == 0
            and isinstance(view, FullView))
