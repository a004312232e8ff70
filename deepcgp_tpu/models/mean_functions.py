"""Mean functions (rebuild of `conv_gp/mean_functions.py`).

The conv mean functions implement the "identity/residual" mean: a frozen
conv2d whose delta filter copies the centre pixel of each patch, so a layer's
GP models the residual around an identity image map
(`conv_gp/mean_functions.py:16-26`; flag ``--identity-mean``,
`conv_gp/models.py:94-99`).  Filters are pytree leaves but are built
non-trainable by the reference (`conv_gp/models.py:99`); the optimizer masks
them out (see deepcgp_tpu.training.optim).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from deepcgp_tpu.utils import struct


@struct.dataclass
class Zero:
    """gpflow Zero mean (default when --identity-mean is off,
    `conv_gp/models.py:97-98`)."""

    output_dim: int = struct.field(pytree_node=False, default=1)

    def __call__(self, X: jax.Array) -> jax.Array:
        N = X.shape[0]
        return jnp.zeros((N, 1), dtype=X.dtype)  # broadcasts against [N, O]


def _identity_filter(filter_size: int, fm_in: int, fm_out: int,
                     all_channels: bool, dtype) -> np.ndarray:
    """Delta filter [fh, fw, in, out].

    ``all_channels``: IdentityConv2dMean copies the centre pixel of every
    channel pair (`conv_gp/mean_functions.py:21-26`); Conv2dMean copies only
    (in=0 -> out=0) and leaves the rest zero-mean
    (`conv_gp/mean_functions.py:33-41`).
    """
    filt = np.zeros((filter_size, filter_size, fm_in, fm_out))
    c = filter_size // 2
    if all_channels:
        filt[c, c, :, :] = 1.0
    else:
        filt[c, c, 0, 0] = 1.0
    return filt.astype(dtype)


@struct.dataclass
class Conv2dMean:
    """conv2d(VALID) mean over images; output flattened to [N, -1]
    (`conv_gp/mean_functions.py:28-41`)."""

    conv_filter: jax.Array  # [fh, fw, in, out]
    stride: int = struct.field(pytree_node=False, default=1)

    @classmethod
    def create(cls, filter_size: int, feature_maps_in: int,
               feature_maps_out: int = 1, stride: int = 1,
               identity: bool = False, dtype=jnp.float32) -> "Conv2dMean":
        filt = _identity_filter(filter_size, feature_maps_in,
                                feature_maps_out, identity, dtype)
        return cls(conv_filter=jnp.asarray(filt), stride=stride)

    def conv(self, NHWC_X: jax.Array) -> jax.Array:
        return lax.conv_general_dilated(
            NHWC_X, self.conv_filter.astype(NHWC_X.dtype),
            window_strides=(self.stride, self.stride),
            padding='VALID',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'))

    def __call__(self, NHWC_X: jax.Array) -> jax.Array:
        out = self.conv(NHWC_X)
        return out.reshape(out.shape[0], -1)


@struct.dataclass
class IdentityConv2dMean(Conv2dMean):
    """Centre-pixel copy across all channel pairs, NHWC output
    (`conv_gp/mean_functions.py:6-26`); also used host-side to propagate
    initialisation inputs between layers (`conv_gp/models.py:29-33`)."""

    @classmethod
    def create(cls, filter_size: int, feature_maps_in: int,
               feature_maps_out: int = 1, stride: int = 1,
               dtype=jnp.float32) -> "IdentityConv2dMean":
        filt = _identity_filter(filter_size, feature_maps_in,
                                feature_maps_out, True, dtype)
        return cls(conv_filter=jnp.asarray(filt), stride=stride)

    def __call__(self, NHWC_X: jax.Array) -> jax.Array:
        return self.conv(NHWC_X)


@struct.dataclass
class PatchwiseConv2d:
    """Matmul form of Conv2dMean over pre-extracted patches, for partial
    views (`conv_gp/mean_functions.py:43-59`).  Takes [N, P, L] patches
    (reference uses [P, N, L]) and returns [N, P]."""

    conv_filter: jax.Array  # [fh, fw, in, out]

    @classmethod
    def create(cls, filter_size: int, feature_maps_in: int,
               dtype=jnp.float32) -> "PatchwiseConv2d":
        filt = _identity_filter(filter_size, feature_maps_in, 1, False, dtype)
        return cls(conv_filter=jnp.asarray(filt))

    def __call__(self, NPL_patches: jax.Array) -> jax.Array:
        L = self.conv_filter.shape[0] * self.conv_filter.shape[1] * \
            self.conv_filter.shape[2]
        kernel = self.conv_filter.reshape(L, -1).astype(NPL_patches.dtype)
        out = jnp.einsum('npl,lo->npo', NPL_patches, kernel)  # o == 1
        return out[..., 0]
