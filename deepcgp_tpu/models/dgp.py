"""Doubly-stochastic deep GP core.

Replaces the external ``doubly_stochastic_dgp`` package (empty submodule in
the reference mount; behaviour reconstructed from its call sites —
`conv_gp/models.py:66-70`, `conv_gp/utils/log.py:62`,
`conv_gp/utils/tensorboard.py:32,73` — and the Salimbeni-Deisenroth
formulation; SURVEY.md §2 external row):

* S-sample reparameterised propagation through the layer stack,
* minibatch-scaled ELBO = N/batch * E_q[log p(y|f)] - sum_l KL_l,
* ``predict_y`` (S-sample predictive class probabilities),
* ``propagate`` (samples + means + vars per layer, for observability).

Schedule details:
* layer Kuu Choleskys are computed once per step and shared across the S
  samples (``precompute``);
* the first layer's conditional depends only on the minibatch X (identical
  across samples), so it is evaluated once and sampled S times instead of
  S evaluations (mathematically identical; the reference re-evaluates);
* sampling noise comes from an explicit PRNG key — fully deterministic.
"""

from __future__ import annotations

import typing

import jax
import jax.numpy as jnp

from deepcgp_tpu.config import settings
from deepcgp_tpu.utils import struct


def _reparameterize(mean: jax.Array, var: jax.Array,
                    z: jax.Array) -> jax.Array:
    """Salimbeni DGP reparameterisation: mean + z * sqrt(var + jitter)
    (jitter floor from gpflowrc, matching the external package)."""
    return mean + z * jnp.sqrt(var + settings.jitter)


def mc_normal(key: jax.Array, shape, dtype) -> jax.Array:
    """Standard normals for Monte-Carlo sampling, drawn through the 'rbg'
    bit generator (XLA ``RngBitGenerator``).

    rbg generates bits at near-memory speed, where the default threefry
    generator spends arithmetic on every draw.  The rbg key is
    derived deterministically from the (threefry) key's data, so explicit
    key threading, reproducibility given a seed, and trajectory parity with
    the oracle trainer (which draws through this same helper) are all
    unchanged.  Only the *stream* differs — draws are still iid N(0,1),
    which is all the doubly-stochastic ELBO asks of them.
    """
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        data = jax.random.key_data(key)
    else:
        data = key
    data = data.reshape(-1).astype(jnp.uint32)
    rbg = jax.random.wrap_key_data(jnp.concatenate([data, data]),
                                   impl='rbg')
    return jax.random.normal(rbg, shape, dtype)


class PropagateResult(typing.NamedTuple):
    samples: list  # per layer: [S, N, O_l]
    means: list
    variances: list


@struct.dataclass
class DGP:
    """The deep GP model: a stack of layers + a likelihood.

    ``num_data`` is the full training-set size used for minibatch ELBO
    scaling (DGP_Base construction at `conv_gp/models.py:66-70`).
    """

    layers: tuple
    likelihood: object
    num_data: int = struct.field(pytree_node=False, default=0)
    num_samples: int = struct.field(pytree_node=False, default=10)

    def precompute(self):
        """Per-layer caches with all same-shape Kuu grams (conditional +
        frozen KL priors) factorized — WITH their explicit factor inverses
        (linalg.chol_with_inv) — in ONE batched call per distinct M.
        Factorization calls are latency-bound, so the stack shares one
        batched factorization; the inverses turn every downstream
        triangular solve (conditional + gauss_kl, forward AND backward)
        into matmuls at the inverse-apply precision."""
        from deepcgp_tpu.ops import linalg
        grams = [layer.kuu_grams() for layer in self.layers]
        flat = [g for gs in grams for g in gs]
        pairs: list = [None] * len(flat)
        by_shape: dict = {}
        for i, g in enumerate(flat):
            by_shape.setdefault(g.shape, []).append(i)
        for idxs in by_shape.values():
            if len(idxs) == 1:
                pairs[idxs[0]] = linalg.chol_with_inv(flat[idxs[0]])
            else:
                Lb, Lib = linalg.chol_with_inv(
                    jnp.stack([flat[i] for i in idxs]))
                for k, i in enumerate(idxs):
                    pairs[i] = (Lb[k], Lib[k])
        caches, pos = [], 0
        for layer, gs in zip(self.layers, grams):
            caches.append(layer.make_cache(tuple(pairs[pos:pos + len(gs)])))
            pos += len(gs)
        return tuple(caches)

    def propagate(self, X: jax.Array, key: jax.Array, S: int,
                  caches=None) -> PropagateResult:
        """Draw S sample paths through the stack.  X: [N, D]."""
        if caches is None:
            caches = self.precompute()
        N = X.shape[0]
        samples, means, variances = [], [], []
        F = None  # [S, N, O]; None means "layer input identical across S"
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            key, sub = jax.random.split(key)
            if F is None:
                # First layer: one conditional evaluation, S samples.
                mean, var = layer.conditional_mean_var(cache, X)
                mean = jnp.broadcast_to(mean[None], (S,) + mean.shape)
                var = jnp.broadcast_to(var[None], (S,) + var.shape)
            else:
                # Fold the S sample paths into the batch axis instead of
                # vmapping the layer: rows are independent in every
                # conditional, so one [S*N]-row evaluation is mathematically
                # identical — and it reaches the layer as ONE wide
                # triangular-solve chain / one conv instead of an S-batched
                # custom call (batched chol/solve custom-calls are
                # latency-bound) plus vmap-transpose copies in the backward.
                S_, N_, O_ = F.shape
                mean, var = layer.conditional_mean_var(
                    cache, F.reshape(S_ * N_, O_))
                mean = mean.reshape(S_, N_, -1)
                var = var.reshape(S_, N_, -1)
            z = mc_normal(sub, mean.shape, mean.dtype)
            F = _reparameterize(mean, var, z)
            samples.append(F)
            means.append(mean)
            variances.append(var)
        return PropagateResult(samples, means, variances)

    # -- training ------------------------------------------------------------
    def expected_log_likelihood(self, X: jax.Array, Y: jax.Array,
                                key: jax.Array, caches=None) -> jax.Array:
        """Monte-Carlo E_q[log p(y | f_L)] summed over the batch."""
        res = self.propagate(X, key, self.num_samples, caches)
        Fmean, Fvar = res.means[-1], res.variances[-1]     # [S, N, K]
        Yb = jnp.broadcast_to(Y[None], (self.num_samples,) + Y.shape)
        ve = self.likelihood.variational_expectations(Fmean, Fvar, Yb)
        return jnp.sum(jnp.mean(ve, axis=0))

    def prior_kl(self, caches=None) -> jax.Array:
        if caches is None:
            caches = (None,) * len(self.layers)
        return sum(layer.KL(cache)
                   for layer, cache in zip(self.layers, caches))

    def elbo(self, X: jax.Array, Y: jax.Array, key: jax.Array) -> jax.Array:
        """Minibatch ELBO (what `model.compute_log_likelihood` evaluates)."""
        caches = self.precompute()
        scale = self.num_data / X.shape[0]
        return scale * self.expected_log_likelihood(X, Y, key, caches) \
            - self.prior_kl(caches)

    def compute_log_likelihood(self, X: jax.Array, Y: jax.Array,
                               key: jax.Array) -> jax.Array:
        """Reference API alias: the minibatch ELBO
        (``model.compute_log_likelihood`` at `conv_gp/utils/tensorboard.py:32`)."""
        return self.elbo(X, Y, key)

    # -- prediction ----------------------------------------------------------
    def predict_y(self, X: jax.Array, key: jax.Array, S: int):
        """Per-sample predictive mean/var of y (class probabilities for the
        robust-max likelihood): ([S, N, K], [S, N, K]) — contract of
        ``model.predict_y(X, S)`` at `conv_gp/utils/log.py:62`."""
        res = self.propagate(X, key, S)
        return self.likelihood.predict_mean_and_var(
            res.means[-1], res.variances[-1])

    def predict_density(self, X: jax.Array, Y: jax.Array, key: jax.Array,
                        S: int) -> jax.Array:
        """Per-point predictive log-density log E_S[p(y | f_L)]
        (DGP_Base API; log-mean-exp over the S sample paths)."""
        res = self.propagate(X, key, S)
        Yb = jnp.broadcast_to(Y[None], (S,) + Y.shape)
        logp = self.likelihood.predict_density(res.means[-1],
                                               res.variances[-1], Yb)
        return jax.nn.logsumexp(logp, axis=0) - jnp.log(float(S))
