"""Base (patch-space) kernels: RBF and ArcCosine.

JAX equivalents of the gpflow 1.x kernels the reference selects at
`conv_gp/models.py:114-121` (hidden layers) and `conv_gp/models.py:160-191`
(last layer, with ARD lengthscales for the plain-RBF option).

Kernels are pytree dataclasses holding *unconstrained* parameters; the
positive bijector matches gpflow's Log1pe so initial constrained values are
identical to the reference (variance=5.0, lengthscales=5.0 at
`conv_gp/models.py:115-117`).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.ops.distances import square_distance
from deepcgp_tpu.utils import struct
from deepcgp_tpu.utils.transforms import positive_backward, positive_forward


@struct.dataclass
class RBF:
    """k(x, x') = variance * exp(-||x - x'||^2 / (2 lengthscales^2)).

    ``raw_lengthscales`` is a scalar for isotropic kernels or [D] for ARD
    (the reference's last-layer RBF uses ARD, `conv_gp/models.py:163-165`).
    """

    raw_variance: jax.Array
    raw_lengthscales: jax.Array

    @classmethod
    def create(cls, variance=5.0, lengthscales=5.0, *, ard_dim: int | None = None,
               dtype=jnp.float32) -> "RBF":
        ls = np.asarray(lengthscales, dtype=np.float64)
        if ard_dim is not None and ls.ndim == 0:
            ls = np.full((ard_dim,), float(ls))
        return cls(
            raw_variance=jnp.asarray(positive_backward(variance), dtype=dtype),
            raw_lengthscales=jnp.asarray(positive_backward(ls), dtype=dtype),
        )

    @property
    def variance(self) -> jax.Array:
        return positive_forward(self.raw_variance)

    @property
    def lengthscales(self) -> jax.Array:
        return positive_forward(self.raw_lengthscales)

    def K(self, X: jax.Array, X2: jax.Array | None = None) -> jax.Array:
        ls = self.lengthscales
        if ls.ndim == 0:
            # Isotropic: scale the SQUARED DISTANCE by 1/ls^2 instead of
            # the inputs — algebraically identical, but the scalar multiply
            # fuses into the exp epilogue for free, where dividing the
            # [N*P, L] im2col tensor is a separate bandwidth pass (and its
            # backward re-reads it).
            d2 = square_distance(X, X2)
            return self.variance * jnp.exp((-0.5 / jnp.square(ls)) * d2)
        Xl = X / ls
        X2l = None if X2 is None else X2 / ls
        d2 = square_distance(Xl, X2l)
        return self.variance * jnp.exp(-0.5 * d2)

    def Kdiag(self, X: jax.Array) -> jax.Array:
        return jnp.full(X.shape[:-1], 1.0, dtype=X.dtype) * self.variance


@struct.dataclass
class ArcCosine:
    """gpflow 1.x ArcCosine kernel (orders 0/1/2), selected by
    ``--base-kernel acos`` (`conv_gp/models.py:118-119`, order=0).

    K(x, y) = variance / pi * J(theta) * ||x||^order ||y||^order with the
    weighted product <x, y> = sum_d w_d x_d y_d + bias_variance.
    """

    raw_variance: jax.Array
    raw_weight_variances: jax.Array
    raw_bias_variance: jax.Array
    order: int = struct.field(pytree_node=False, default=0)

    @classmethod
    def create(cls, variance=1.0, weight_variances=1.0, bias_variance=1.0,
               *, order: int = 0, ard_dim: int | None = None,
               dtype=jnp.float32) -> "ArcCosine":
        assert order in (0, 1, 2)
        wv = np.asarray(weight_variances, dtype=np.float64)
        if ard_dim is not None and wv.ndim == 0:
            wv = np.full((ard_dim,), float(wv))
        return cls(
            raw_variance=jnp.asarray(positive_backward(variance), dtype=dtype),
            raw_weight_variances=jnp.asarray(positive_backward(wv), dtype=dtype),
            raw_bias_variance=jnp.asarray(positive_backward(bias_variance),
                                          dtype=dtype),
            order=order,
        )

    @property
    def variance(self) -> jax.Array:
        return positive_forward(self.raw_variance)

    @property
    def weight_variances(self) -> jax.Array:
        return positive_forward(self.raw_weight_variances)

    @property
    def bias_variance(self) -> jax.Array:
        return positive_forward(self.raw_bias_variance)

    def _weighted_product(self, X, X2=None, precision=None):
        w = self.weight_variances
        if X2 is None:
            return jnp.sum(w * jnp.square(X), axis=-1) + self.bias_variance
        return jnp.matmul(w * X, jnp.swapaxes(X2, -1, -2),
                          precision=precision) + self.bias_variance

    def _J(self, theta):
        if self.order == 0:
            return math.pi - theta
        elif self.order == 1:
            return jnp.sin(theta) + (math.pi - theta) * jnp.cos(theta)
        else:
            c = jnp.cos(theta)
            return 3.0 * jnp.sin(theta) * c + (math.pi - theta) * (1.0 + 2.0 * c ** 2)

    def K(self, X: jax.Array, X2: jax.Array | None = None) -> jax.Array:
        denom_X = jnp.sqrt(self._weighted_product(X))
        if X2 is None:
            # Self-gram headed for a Cholesky: exact-f32 matmul passes
            # (see ops/distances.py::square_distance for the rationale).
            numerator = self._weighted_product(
                X, X, precision=jax.lax.Precision.HIGHEST)
            denom_X2 = denom_X
        else:
            numerator = self._weighted_product(X, X2)
            denom_X2 = jnp.sqrt(self._weighted_product(X2))
        cos_theta = numerator / denom_X[..., :, None] / denom_X2[..., None, :]
        # Guard against acos(|x|>=1): gpflow uses 1e-15, which is an f64
        # guard — it rounds away in f32, leaving arccos'(1.0) = inf on the
        # diagonal and NaN gradients.  Scale the squeeze to the dtype.
        eps = 1e-15 if cos_theta.dtype == jnp.float64 else 1e-6
        theta = jnp.arccos(jnp.clip(eps + (1.0 - 2.0 * eps) * cos_theta,
                                    -1.0, 1.0))
        scale = (denom_X[..., :, None] ** self.order
                 * denom_X2[..., None, :] ** self.order)
        return self.variance * (1.0 / math.pi) * self._J(theta) * scale

    def Kdiag(self, X: jax.Array) -> jax.Array:
        prod = self._weighted_product(X)
        return self.variance * (1.0 / math.pi) * self._J(0.0) * prod ** self.order
