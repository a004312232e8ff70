"""Likelihoods: robust-max multiclass (the reference's only likelihood,
``MultiClass(10)`` at `conv_gp/models.py:66-70`) plus Gaussian for tests.

The robust-max inverse link (gpflow 1.x semantics):
  p(y=c | f) = 1 - eps           if c == argmax(f)
             = eps / (K - 1)     otherwise.

``variational_expectations`` needs P(f_c is largest) under the factorised
Gaussian q(f) = N(mu, diag var); computed with 1-D Gauss-Hermite quadrature
exactly like gpflow's ``RobustMax.prob_is_largest`` — but batched over all
leading axes at once (the reference evaluates per feed batch through a TF
graph).  Everything here is jit/vmap friendly: static shapes, no host sync.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.utils import struct


def _gh_points(n: int, dtype) -> tuple[jax.Array, jax.Array]:
    x, w = np.polynomial.hermite.hermgauss(n)
    return jnp.asarray(x, dtype=dtype), jnp.asarray(w, dtype=dtype)


@struct.dataclass
class MultiClass:
    """Robust-max multiclass likelihood over K classes."""

    num_classes: int = struct.field(pytree_node=False, default=10)
    epsilon: float = struct.field(pytree_node=False, default=1e-3)
    num_gauss_hermite: int = struct.field(pytree_node=False, default=20)

    @property
    def _eps_k1(self) -> float:
        return self.epsilon / (self.num_classes - 1.0)

    def prob_is_largest(self, Y: jax.Array, mu: jax.Array,
                        var: jax.Array) -> jax.Array:
        """P(f_{y_n} >= f_j forall j) for each row.

        Y: [..., 1] int labels; mu, var: [..., K].  Returns [..., 1].
        Mirrors gpflow RobustMax.prob_is_largest (incl. its CDF clipping).
        """
        dtype = mu.dtype
        gh_x, gh_w = _gh_points(self.num_gauss_hermite, dtype)
        K = self.num_classes
        oh_on = jax.nn.one_hot(Y[..., 0], K, dtype=dtype)       # [..., K]
        mu_sel = jnp.sum(oh_on * mu, axis=-1)                    # [...]
        var_sel = jnp.sum(oh_on * var, axis=-1)

        # Quadrature grid centred on the selected latent.  [..., H]
        X = mu_sel[..., None] + gh_x * jnp.sqrt(
            jnp.clip(2.0 * var_sel[..., None], 1e-10))

        # CDF of every latent at every grid point.  [..., K, H]
        dist = (X[..., None, :] - mu[..., :, None]) / jnp.sqrt(
            jnp.clip(var[..., :, None], 1e-10))
        cdfs = 0.5 * (1.0 + jax.lax.erf(dist / math.sqrt(2.0)))
        cdfs = cdfs * (1.0 - 2e-4) + 1e-4                        # gpflow clip

        # Blank the selected latent's own CDF to 1.
        cdfs = cdfs * (1.0 - oh_on[..., None]) + oh_on[..., None]

        prod = jnp.prod(cdfs, axis=-2)                           # [..., H]
        p = jnp.sum(prod * gh_w, axis=-1) / math.sqrt(math.pi)
        return p[..., None]

    def variational_expectations(self, Fmu: jax.Array, Fvar: jax.Array,
                                 Y: jax.Array) -> jax.Array:
        """E_q[log p(y | f)]: [..., 1]."""
        p = self.prob_is_largest(Y, Fmu, Fvar)
        ve = p * math.log(1.0 - self.epsilon) + \
            (1.0 - p) * math.log(self._eps_k1)
        return ve

    def _prob_each_is_largest(self, mu: jax.Array, var: jax.Array):
        """P(f_c >= f_j forall j) for EVERY class at once: [..., K].

        One quadrature batched over the class axis instead of K separate
        passes (the serving hot path)."""
        dtype = mu.dtype
        gh_x, gh_w = _gh_points(self.num_gauss_hermite, dtype)
        K = self.num_classes
        # Grid centred on each candidate class c: [..., K_c, H].
        X = mu[..., :, None] + gh_x * jnp.sqrt(
            jnp.clip(2.0 * var[..., :, None], 1e-10))
        # CDF of latent j at candidate c's grid: [..., K_c, K_j, H].
        dist = (X[..., :, None, :] - mu[..., None, :, None]) / jnp.sqrt(
            jnp.clip(var[..., None, :, None], 1e-10))
        cdfs = 0.5 * (1.0 + jax.lax.erf(dist / math.sqrt(2.0)))
        cdfs = cdfs * (1.0 - 2e-4) + 1e-4                        # gpflow clip
        # Blank each candidate's own CDF (j == c) to 1.
        eye = jnp.eye(K, dtype=dtype)[..., :, :, None]
        cdfs = cdfs * (1.0 - eye) + eye
        prod = jnp.prod(cdfs, axis=-2)                           # [..., K, H]
        return jnp.sum(prod * gh_w, axis=-1) / math.sqrt(math.pi)

    def predict_mean_and_var(self, Fmu: jax.Array, Fvar: jax.Array):
        """Class probabilities (and Bernoulli variances) under q(f):
        p(y=c) = P(f_c largest)(1 - eps) + (1 - P(f_c largest)) eps/(K-1)."""
        p = self._prob_each_is_largest(Fmu, Fvar)                # [..., K]
        mean = p * (1.0 - self.epsilon) + (1.0 - p) * self._eps_k1
        return mean, mean - jnp.square(mean)

    def predict_density(self, Fmu: jax.Array, Fvar: jax.Array,
                        Y: jax.Array) -> jax.Array:
        p = self.prob_is_largest(Y, Fmu, Fvar)
        den = p * (1.0 - self.epsilon) + (1.0 - p) * self._eps_k1
        return jnp.log(den)


@struct.dataclass
class Gaussian:
    """Isotropic Gaussian likelihood (not used by the reference experiments;
    provided for regression-style tests of the DGP core)."""

    raw_variance: jax.Array

    @classmethod
    def create(cls, variance=1.0, dtype=jnp.float32) -> "Gaussian":
        from deepcgp_tpu.utils.transforms import positive_backward
        return cls(raw_variance=jnp.asarray(positive_backward(variance),
                                            dtype=dtype))

    @property
    def variance(self) -> jax.Array:
        from deepcgp_tpu.utils.transforms import positive_forward
        return positive_forward(self.raw_variance)

    def variational_expectations(self, Fmu, Fvar, Y):
        v = self.variance
        ve = (-0.5 * math.log(2.0 * math.pi) - 0.5 * jnp.log(v)
              - 0.5 * (jnp.square(Y - Fmu) + Fvar) / v)
        return jnp.sum(ve, axis=-1, keepdims=True)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance
