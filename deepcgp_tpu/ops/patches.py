"""Image-patch extraction (im2col).

Replaces ``tf.extract_image_patches`` (`conv_gp/views.py:34-38`).  The patch
element ordering matches TF's: within a patch, elements run row-major over
(filter_h, filter_w, channel) — channels fastest — so inducing-patch
checkpoints and conv mean-function filters line up with the reference.

Two implementations:

* :func:`extract_patches` — static strided slices, one per filter offset,
  stacked and reshaped.  Pure data movement; XLA fuses it into downstream
  consumers.  This is the default.
* :func:`extract_patches_conv` — ``lax.conv_general_dilated_patches``
  (kept for cross-checking / benchmarking).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def out_size(in_size: int, filter_size: int, stride: int, dilation: int = 1) -> int:
    """VALID-padding output size (reference `conv_gp/views.py:66-68`)."""
    eff = (filter_size - 1) * dilation + 1
    return (in_size - eff) // stride + 1


def extract_patches(NHWC_X: jax.Array, filter_size: int, stride: int = 1,
                    dilation: int = 1) -> jax.Array:
    """[N, H, W, C] -> [N, P, L] with P = Hout*Wout, L = fh*fw*C.

    Patch ordering: patches run row-major over (out_h, out_w); elements within
    a patch run row-major over (fh, fw, C) — identical to
    ``tf.extract_image_patches`` as used at `conv_gp/views.py:34-44`.
    """
    N, H, W, C = NHWC_X.shape
    Hout = out_size(H, filter_size, stride, dilation)
    Wout = out_size(W, filter_size, stride, dilation)
    slices = []
    for dy in range(filter_size):
        for dx in range(filter_size):
            y0 = dy * dilation
            x0 = dx * dilation
            sl = lax.slice(
                NHWC_X,
                (0, y0, x0, 0),
                (N, y0 + (Hout - 1) * stride + 1, x0 + (Wout - 1) * stride + 1, C),
                (1, stride, stride, 1),
            )  # [N, Hout, Wout, C]
            slices.append(sl)
    # [N, Hout, Wout, fh*fw, C]
    stacked = jnp.stack(slices, axis=3)
    return stacked.reshape(N, Hout * Wout, filter_size * filter_size * C)


def extract_patches_native(NHWC_X: jax.Array, filter_size: int,
                           stride: int = 1, dilation: int = 1) -> jax.Array:
    """[N, H, W, C] -> [N, P, L] in ``conv_general_dilated_patches``'s NATIVE
    within-patch element order (C, fh, fw) — channels SLOWEST, the opposite
    of TF's — with no permutation applied.

    Only for consumers whose math is invariant to a fixed within-patch
    element permutation (pairwise distances/inner products among patches of
    one extraction with a scalar lengthscale — e.g. the ConvKernel.Kdiag
    self-gram, `conv_gp/kernels.py:108-115`).  The payoff is layout: the
    conv lowering births the tensor with the L axis minor ({2,1,0}), exactly
    what the gram matmuls want, so the trailing reshape is a bitcast and
    none of the stack+reshape relayout copies of :func:`extract_patches`
    appear.
    """
    N, H, W, C = NHWC_X.shape
    Hout = out_size(H, filter_size, stride, dilation)
    Wout = out_size(W, filter_size, stride, dilation)
    patches = lax.conv_general_dilated_patches(
        NHWC_X,
        filter_shape=(filter_size, filter_size),
        window_strides=(stride, stride),
        padding='VALID',
        rhs_dilation=(dilation, dilation),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
    )  # [N, Hout, Wout, C*fh*fw] ordered (C, fh, fw)
    return patches.reshape(N, Hout * Wout,
                           filter_size * filter_size * C)


def native_perm(filter_size: int, feature_maps: int):
    """Column permutation relating the two within-patch element orders:
    ``patches_native[..., i] == patches_tf[..., native_perm(f, C)[i]]``.

    Native index i = c*f^2 + (fy*f + fx) (channels slowest, the
    conv-lowered order); TF index = (fy*f + fx)*C + c (channels fastest,
    the reference's `tf.extract_image_patches` order, `conv_gp/views.py:34-38`).
    Apply the same permutation to any [L]-indexed quantity (inducing-patch
    columns ``Z[:, perm]``, ARD lengthscales) to evaluate TF-order-stored
    parameters against native-order patches."""
    import numpy as np
    f2 = filter_size * filter_size
    i = np.arange(f2 * feature_maps)
    return ((i % f2) * feature_maps + i // f2).astype(np.int32)


def extract_patches_conv(NHWC_X: jax.Array, filter_size: int, stride: int = 1,
                         dilation: int = 1) -> jax.Array:
    """Same contract as :func:`extract_patches`, via
    ``conv_general_dilated_patches`` (feature order there is (C, fh, fw);
    we permute to TF's (fh, fw, C))."""
    N, H, W, C = NHWC_X.shape
    Hout = out_size(H, filter_size, stride, dilation)
    Wout = out_size(W, filter_size, stride, dilation)
    patches = lax.conv_general_dilated_patches(
        NHWC_X,
        filter_shape=(filter_size, filter_size),
        window_strides=(stride, stride),
        padding='VALID',
        rhs_dilation=(dilation, dilation),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
    )  # [N, Hout, Wout, C*fh*fw] ordered (C, fh, fw)
    patches = patches.reshape(N, Hout, Wout, C, filter_size * filter_size)
    patches = jnp.swapaxes(patches, -1, -2)  # (fh*fw, C)
    return patches.reshape(N, Hout * Wout, filter_size * filter_size * C)
