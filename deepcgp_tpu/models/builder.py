"""Model assembly from flags.

Rebuild of ``ModelBuilder`` (`conv_gp/models.py:35-247`): parse per-layer
comma lists, stack hidden ConvLayers + a final SVGP layer, wire the
MultiClass(10) likelihood, reproduce the reference's initialisation
semantics (k-means inducing patches, identity-conv propagation of init
inputs, fresh q_sqrt scaled 1e-5) and checkpoint loading with the
shallower-to-deeper depth remap.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.config import settings
from deepcgp_tpu.models.base_kernels import ArcCosine, RBF
from deepcgp_tpu.models.conv_kernels import AdditivePatchKernel, ConvKernel
from deepcgp_tpu.models.dgp import DGP
from deepcgp_tpu.models.inducing import (inducing_points_from_data,
                                         patch_inducing_points)
from deepcgp_tpu.models.layers import ConvLayer, SVGPLayer
from deepcgp_tpu.models.likelihoods import MultiClass
from deepcgp_tpu.models.mean_functions import Conv2dMean, Zero
from deepcgp_tpu.models.views import FullView


_T0 = time.time()


def _trace(msg: str) -> None:
    """Build-stage breadcrumbs (DEEPCGP_VERBOSE_BUILD=1)."""
    if os.environ.get('DEEPCGP_VERBOSE_BUILD'):
        print(f"[build +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
              flush=True)


def parse_ints(int_string: str) -> list:
    """'384,384' -> [384, 384] (`conv_gp/models.py:14-18`)."""
    if int_string == '':
        return []
    return [int(i) for i in str(int_string).split(',')]


def image_HW(patch_count: int) -> list:
    side = int(np.sqrt(patch_count))
    return [side, side]


def identity_conv(key, NHWC_X: np.ndarray, filter_size: int, fm_in: int,
                  fm_out: int, stride: int) -> np.ndarray:
    """Propagate initialisation inputs to the next layer with the identity
    conv over 1000 random training images (`conv_gp/models.py:29-33`).

    The identity mean's delta filter (centre weight 1 for every in->out
    channel pair) makes the VALID conv equal to a strided centre-pixel slice
    summed over input channels — computed here in host numpy because this is
    one-shot init work on host arrays."""
    idx = np.asarray(jax.random.randint(key, (1000,), 0, NHWC_X.shape[0]))
    X = np.asarray(NHWC_X)[idx]
    c = filter_size // 2
    Ho = (X.shape[1] - filter_size) // stride + 1
    Wo = (X.shape[2] - filter_size) // stride + 1
    centers = X[:, c:c + stride * Ho:stride, c:c + stride * Wo:stride, :]
    out = centers.sum(axis=-1, keepdims=True)
    return np.repeat(out, fm_out, axis=-1).astype(X.dtype)


@dataclasses.dataclass
class BuilderFlags:
    """The subset of CLI flags the builder consumes
    (`conv_gp/arguments.py:9-43` defaults)."""
    M: str = '384,384'
    feature_maps: str = '10'
    filter_sizes: str = '5,5'
    strides: str = '2,1'
    base_kernel: str = 'rbf'
    last_kernel: str = 'conv'
    white: bool = False
    identity_mean: bool = False
    num_samples: int = 10
    batch_size: int = 32


def build_model(flags, NHWC_X_train: np.ndarray, Y_train: np.ndarray,
                key: jax.Array, loaded_parameters: dict | None = None,
                dtype=None) -> DGP:
    """`conv_gp/models.py:43-70`.  ``loaded_parameters`` is the per-layer
    dict produced by deepcgp_tpu.utils.checkpoint.parse_layer_parameters."""
    if dtype is None:
        dtype = settings.float_type
    loaded_parameters = loaded_parameters or {}
    Ms = parse_ints(flags.M)
    feature_maps = parse_ints(flags.feature_maps)
    strides = parse_ints(flags.strides)
    filter_sizes = parse_ints(flags.filter_sizes)
    assert len(strides) == len(filter_sizes)
    assert len(feature_maps) == len(Ms) - 1

    layers = []
    H_X = NHWC_X_train
    for i in range(len(feature_maps)):
        key, sub = jax.random.split(key)
        _trace(f"conv layer {i}: M={Ms[i]} fm={feature_maps[i]} ...")
        layer, H_X = _conv_layer(flags, sub, H_X, Ms[i], feature_maps[i],
                                 filter_sizes[i], strides[i],
                                 loaded_parameters.get(i), dtype)
        _trace(f"conv layer {i} done")
        layers.append(layer)

    last_params = None
    if loaded_parameters:
        last_params = loaded_parameters.get(max(loaded_parameters.keys()))
    key, sub = jax.random.split(key)
    _trace(f"last layer: M={Ms[-1]} kernel={flags.last_kernel} ...")
    layers.append(_last_layer(flags, sub, H_X, Ms[-1], filter_sizes[-1],
                              strides[-1], last_params, dtype))
    _trace("last layer done")

    return DGP(layers=tuple(layers),
               likelihood=MultiClass(
                   10, num_gauss_hermite=settings.num_gauss_hermite_points),
               num_data=NHWC_X_train.shape[0],
               num_samples=flags.num_samples)


def _conv_layer(flags, key, NHWC_X, M, feature_map, filter_size, stride,
                layer_params, dtype):
    """`conv_gp/models.py:86-140`."""
    layer_params = layer_params or {}
    N, H, W, C = NHWC_X.shape
    view = FullView(input_size=(H, W), filter_size=filter_size,
                    feature_maps=C, stride=stride)

    if flags.identity_mean:
        mean = Conv2dMean.create(filter_size, C, feature_map, stride=stride,
                                 dtype=dtype)
    else:
        mean = Zero()

    k1, k2 = jax.random.split(key)
    H_X = identity_conv(k1, NHWC_X, filter_size, C, feature_map, stride)

    if 'Z' in layer_params:
        Z = np.asarray(layer_params['Z'])
    else:
        _trace("  patch_inducing_points (k-means) ...")
        Z = np.asarray(patch_inducing_points(
            k2, jnp.asarray(NHWC_X, dtype=dtype), M, filter_size))
        _trace("  patch_inducing_points done")

    if flags.base_kernel == 'rbf':
        base_kernel = RBF.create(
            variance=layer_params.get('base_kernel/variance', 5.0),
            lengthscales=layer_params.get('base_kernel/lengthscales', 5.0),
            dtype=dtype)
    elif flags.base_kernel == 'acos':
        base_kernel = ArcCosine.create(
            order=0,
            variance=layer_params.get('base_kernel/variance', 1.0),
            weight_variances=layer_params.get(
                'base_kernel/weight_variances', 1.0),
            bias_variance=layer_params.get('base_kernel/bias_variance', 1.0),
            dtype=dtype)
    else:
        raise ValueError("Not a valid base-kernel value")

    fresh = layer_params.get('q_sqrt') is None
    layer = ConvLayer.create(
        base_kernel, view, Z, mean_function=mean, white=flags.white,
        gp_count=feature_map,
        q_mu=layer_params.get('q_mu'),
        q_sqrt=layer_params.get('q_sqrt'),
        # Fresh layers start with low variance (`conv_gp/models.py:136-138`).
        q_sqrt_scale=1e-5 if fresh else 1.0,
        dtype=dtype)
    return layer, H_X


def _last_layer(flags, key, H_X, M, filter_size, stride, layer_params, dtype):
    """`conv_gp/models.py:142-198`."""
    layer_params = dict(layer_params or {})
    NHWC = H_X.shape
    conv_output_count = int(np.prod(NHWC[1:]))
    Z = layer_params.get('Z')
    q_mu = layer_params.get('q_mu')
    q_sqrt = layer_params.get('q_sqrt')

    if Z is not None:
        saved_filter_size = int(np.sqrt(np.asarray(Z).shape[1] / NHWC[3]))
        if filter_size != saved_filter_size and flags.last_kernel != 'rbf':
            # Reset on filter-size mismatch (`conv_gp/models.py:152-158`).
            Z = q_mu = q_sqrt = None

    if flags.last_kernel == 'rbf':
        flat = H_X.reshape(H_X.shape[0], -1)
        # A plain-RBF last layer stores its hyperparameters under the
        # UN-prefixed 'kern/{variance,lengthscales}' pathnames, which the
        # reference reads back as bare keys (`conv_gp/models.py:162-164`).
        # The prefixed fallback keeps round-1 snapshots of this rebuild
        # loading unchanged.
        kernel = RBF.create(
            variance=layer_params.get(
                'variance', layer_params.get('base_kernel/variance', 5.0)),
            lengthscales=layer_params.get(
                'lengthscales',
                layer_params.get('base_kernel/lengthscales', 5.0)),
            ard_dim=conv_output_count, dtype=dtype)
        if Z is None:
            Z = np.asarray(inducing_points_from_data(
                key, jnp.asarray(flat, dtype=dtype), M))
    else:
        view = FullView(input_size=(NHWC[1], NHWC[2]),
                        filter_size=filter_size, feature_maps=NHWC[3],
                        stride=stride)
        base = RBF.create(
            variance=layer_params.get('base_kernel/variance', 5.0),
            lengthscales=layer_params.get('base_kernel/lengthscales', 5.0),
            dtype=dtype)
        if Z is None:
            _trace("  last-layer patch k-means ...")
            Z = np.asarray(patch_inducing_points(
                key, jnp.asarray(H_X, dtype=dtype), M, filter_size))
            _trace("  last-layer patch k-means done")
        patch_weights = layer_params.get('patch_weights')
        if flags.last_kernel == 'conv':
            kernel = ConvKernel.create(base, view,
                                       patch_weights=patch_weights,
                                       dtype=dtype)
        elif flags.last_kernel == 'add':
            kernel = AdditivePatchKernel.create(base, view,
                                                patch_weights=patch_weights,
                                                dtype=dtype)
        else:
            raise ValueError("Invalid last layer kernel")

    return SVGPLayer.create(kernel, Z, num_outputs=10,
                            mean_function=Zero(output_dim=10),
                            white=flags.white, q_mu=q_mu, q_sqrt=q_sqrt,
                            dtype=dtype)
