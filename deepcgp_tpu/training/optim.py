"""Optimizers: Adam/SGD with the reference's lr schedule, plus natural
gradients on the variational parameters.

Rebuild of `conv_gp/experiment.py:72-111`:

* exponential staircase lr decay, x0.1 every ``lr_decay_steps``
  (`conv_gp/experiment.py:72-73`);
* gamma schedule for NatGrad:
  min((step/100 * 1e-3 + gamma0) * 0.2^steps_back, 1.0)
  (`conv_gp/experiment.py:74-80`);
* NatGrad on every layer's (q_mu, q_sqrt) + Adam on all other params
  (`conv_gp/experiment.py:90-108`);
* Cholesky-failure backoff: the reference catches a TF
  InvalidArgumentError, bumps ``steps_back`` and retries
  (`conv_gp/experiment.py:38-49`).  JAX Cholesky returns NaN instead of
  raising, so the step checks the proposed variational params for
  non-finite values inside jit and — via ``lax.cond`` — either commits them
  or keeps the old ones and increments ``steps_back``.  No host round-trip.

The natural-gradient math follows Salimbeni, Eleftheriadis & Hensman (2018)
(gpflow's NatGradOptimizer with the default XiNat transform): step in the
natural parameters theta = (S^-1 mu, -1/2 S^-1) along dL/deta, where
eta = (mu, S + mu mu^T) are the expectation parameters; dL/deta is obtained
from (dL/dq_mu, dL/dq_sqrt) by a VJP through eta -> (mu, chol(S)).
"""

from __future__ import annotations

import os
import typing

import jax
import jax.numpy as jnp
import optax
from jax import lax


# Precision of the matmuls whose RESULT IS the new variational state
# (W_new = W R^-T and the mu_new matvecs).  Rounding here feeds back into
# (q_mu, q_sqrt) every step, so they run as full-float32 products (HIGHEST;
# DEFAULT and HIGH are TF32 on the H100).  DEEPCGP_NATGRAD_PRECISION
# overrides.
_STATE_PRECISION = {
    'default': lax.Precision.DEFAULT,
    'high': lax.Precision.HIGH,
    'highest': lax.Precision.HIGHEST,
}[os.environ.get('DEEPCGP_NATGRAD_PRECISION', 'highest')]

# ----------------------------------------------------------------- schedules


def learning_rate_schedule(lr: float, lr_decay_steps: int,
                           staircase: bool = True):
    """x0.1 exponential decay every ``lr_decay_steps``.

    ``staircase=True`` matches the reference's CURRENT source
    (`conv_gp/experiment.py:71-73`).  Its committed result artifacts were
    produced by an earlier code state with CONTINUOUS decay (every
    results/*/log.csv lr column is 0.01*0.1^(t/decay_steps), not a
    staircase) — ``staircase=False`` reproduces those runs exactly
    (--lr-decay-continuous, used by examples/mnist_parity.py)."""
    return optax.exponential_decay(init_value=lr,
                                   transition_steps=lr_decay_steps,
                                   decay_rate=0.1, staircase=staircase)


def gamma_schedule(step, steps_back, gamma0: float):
    t = step.astype(jnp.float64 if jax.config.jax_enable_x64
                    else jnp.float32) / 100.0
    return jnp.minimum((t * 1e-3 + gamma0) * jnp.power(0.2, steps_back), 1.0)


# ------------------------------------------------- Adam with bf16 moments


def _sr_to_bf16(x: jax.Array, salt: jax.Array) -> jax.Array:
    """f32 -> bf16 by STOCHASTIC rounding, with the dither drawn from a
    fused per-element murmur-style integer hash of (flat index, salt) —
    no materialized random tensor, so the store adds zero HBM traffic on
    top of the bf16 write it replaces.

    Why SR: round-to-nearest bf16 moment storage FAILED the soak gate
    (PARITY.md round-4) because Adam's second moment moves ~0.1% per step
    ((1-b2)=1e-3) while bf16 ulp is ~0.8% — RTN freezes v.  SR is
    unbiased (E[sr(x)] = x), so v performs an unbiased random walk around
    the f32 trajectory instead of sticking.

    Mechanics: add a uniform 16-bit dither to the f32 bit pattern, then
    truncate the low 16 mantissa bits — for sign-magnitude floats this is
    exact SR of the magnitude (carries propagate across exponent
    boundaries correctly).  The masked f32 has an exactly-representable
    bf16 value, so the final astype performs no second rounding.  Values
    already exactly representable in bf16 (zero low bits) round to
    themselves: the dither < 2^16 cannot carry.  Non-finite inputs stay
    non-finite or become other non-finites — the trainer's commit guard
    never stores them anyway."""
    assert x.dtype == jnp.float32, x.dtype
    u = lax.bitcast_convert_type(x, jnp.uint32)
    n = x.size
    idx = lax.iota(jnp.uint32, n).reshape(x.shape)
    h = idx * jnp.uint32(2654435761) + salt.astype(jnp.uint32)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * jnp.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    u = (u + (h & jnp.uint32(0xFFFF))) & jnp.uint32(0xFFFF0000)
    return lax.bitcast_convert_type(u, jnp.float32).astype(jnp.bfloat16)


def scale_by_adam_storage(storage_dtype=None, b1=0.9, b2=0.999, eps=1e-8,
                          stochastic_round: bool = False):
    """optax.scale_by_adam with the moment STORAGE dtype decoupled from the
    update arithmetic (which stays in the parameter dtype, f32).

    Why: the m1024 config's Adam+commit fusions stream the
    [10, 1024, 1024] f32 (m, v) stacks in and out every step; bf16
    moments halve 2/3 of that traffic.  The arithmetic is unchanged: moments are upcast to
    f32, updated with the exact optax recurrences + bias correction, and
    rounded once on store — so the only new error is one bf16 rounding of
    (m, v) per step (~0.4% relative), against gradient noise that is
    orders larger.

    With ``storage_dtype=None`` this is arithmetically identical to
    ``optax.scale_by_adam`` (pinned by
    test_training.py::test_adam_storage_matches_optax).

    ``storage_dtype='auto'`` picks PER LEAF: bf16 with stochastic-rounding
    stores for f32 leaves of >= 2^22 elements (the bandwidth-bound moment
    stacks — m1024's [10,1024,1024] q_sqrt moments), parameter dtype for
    everything else.  Small leaves gain nothing from halved traffic, so
    they keep exact f32 moments and the flagship/CLI configs are
    bit-identical to plain optax; the soak evidence for the SR leaves is
    PARITY.md round-4 (all-SR m1024 soak ELBO -173.5 vs f32 -173.6/-179.0
    across seeds — inside the envelope, where RTN bf16 landed 7.5x out).
    """
    auto = storage_dtype == 'auto'

    def _leaf_dtype(p):
        if auto:
            return (jnp.bfloat16 if p.dtype == jnp.float32
                    and p.size >= (1 << 22) else p.dtype)
        return storage_dtype or p.dtype

    def init(params):
        zeros = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, dtype=_leaf_dtype(p)), params)
        zeros2 = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, dtype=_leaf_dtype(p)), params)
        return optax.ScaleByAdamState(
            count=jnp.zeros([], jnp.int32), mu=zeros, nu=zeros2)

    use_sr = auto or (bool(stochastic_round)
                      and storage_dtype == jnp.bfloat16)

    def update(updates, state, params=None):
        del params
        count_inc = state.count + 1
        # Weak-typed exactly like optax.scale_by_adam's bias correction
        # (f64 under x64, f32 otherwise): an earlier f32-pinned form drifted
        # 7e-6/step from optax and broke the f64 trajectory-parity matrix
        # once 'auto' made this transform the default for every config.
        c1 = 1.0 - b1 ** count_inc
        c2 = 1.0 - b2 ** count_inc
        # Distinct dither stream per (step, leaf, moment): the salt feeds
        # the avalanche hash in _sr_to_bf16, so consecutive steps see
        # independent rounding directions per element.
        salt0 = count_inc.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
        leaf_no = [0]

        def one(g, m, v):
            mf = m.astype(g.dtype)
            vf = v.astype(g.dtype)
            mf = b1 * mf + (1.0 - b1) * g
            vf = b2 * vf + (1.0 - b2) * jnp.square(g)
            u = (mf / c1.astype(g.dtype)) / (
                jnp.sqrt(vf / c2.astype(g.dtype)) + eps)
            if (use_sr and g.dtype == jnp.float32
                    and m.dtype == jnp.bfloat16):
                k = leaf_no[0]
                leaf_no[0] += 1
                s = salt0 + jnp.uint32((2 * k * 0x85EBCA77) & 0xFFFFFFFF)
                return (u, _sr_to_bf16(mf, s),
                        _sr_to_bf16(vf, s + jnp.uint32(0x85EBCA77)))
            return u, mf.astype(m.dtype), vf.astype(v.dtype)

        out = jax.tree_util.tree_map(one, updates, state.mu, state.nu)
        us, mus, nus = jax.tree_util.tree_transpose(
            jax.tree_util.tree_structure(updates),
            jax.tree_util.tree_structure((0, 0, 0)), out)
        return us, optax.ScaleByAdamState(count=count_inc, mu=mus, nu=nus)

    return optax.GradientTransformation(init, update)


# ------------------------------------------------------------ trainable mask

_FROZEN_NAMES = ('Z0', 'conv_filter')  # frozen-Z KL snapshot; mean filters
_VARIATIONAL_NAMES = ('q_mu', 'q_sqrt')


def _path_has(path, names) -> bool:
    for entry in path:
        name = getattr(entry, 'name', None)
        if name is not None and name in names:
            return True
    return False


def trainable_mask(model, *, exclude_variational: bool) -> typing.Any:
    """Pytree of bools: True where Adam/SGD should update.

    Mean-function conv filters are frozen (`conv_gp/models.py:99`), Z0 is the
    KL prior snapshot, and under NatGrad the variational params are removed
    from the Adam set (`conv_gp/experiment.py:92-95`).
    """
    def mask_leaf(path, _):
        if _path_has(path, _FROZEN_NAMES):
            return False
        if exclude_variational and _path_has(path, _VARIATIONAL_NAMES):
            return False
        return True
    return jax.tree_util.tree_map_with_path(mask_leaf, model)


def apply_mask(grads, mask):
    return jax.tree_util.tree_map(
        lambda g, m: g if m else jnp.zeros_like(g), grads, mask)


# ----------------------------------------------------------- natural gradient


def _expectation_to_meanvarsqrt(eta1, eta2):
    """eta1 [R, M], eta2 [R, M, M] -> (mu [R, M], W = chol(S) [R, M, M])."""
    S = eta2 - eta1[:, :, None] * eta1[:, None, :]
    return eta1, jnp.linalg.cholesky(S)


def _phi(X):
    """tril with halved diagonal — the projection in the Cholesky
    differential (self-adjoint under the Frobenius inner product)."""
    return jnp.tril(X) - 0.5 * X * jnp.eye(X.shape[-1], dtype=X.dtype)


def _expectation_vjp(mu, W, dmu, dW):
    """VJP of ``_expectation_to_meanvarsqrt`` at (eta1, eta2), WITHOUT
    refactorizing: the primal output chol(S) is the known factor ``W``
    itself (S = W W^T by construction), so the only work is the Cholesky
    pullback — two batched triangular solves instead of a blocked batched
    Cholesky (the single most expensive custom-call chain in the NatGrad
    step; see PARITY.md perf notes).

    Cholesky pullback (Murray 2016; JAX symmetrizes the cotangent):
        S_bar = sym(W^-T phi(W^T W_bar) W^-1),  phi = tril w/ halved diag,
        sym(X) = (X + X^T) / 2.
    Then through S = eta2 - eta1 eta1^T:
        eta2_bar = S_bar
        eta1_bar = dmu - 2 S_bar eta1.
    Equality with ``jax.vjp(_expectation_to_meanvarsqrt, ...)`` is pinned by
    ``test_training.py::test_expectation_vjp_matches_autodiff``.
    """
    P = _phi(jnp.matmul(jnp.swapaxes(W, -1, -2), dW))
    # W^-T P W^-1 via two BACKWARD-STABLE triangular solves.  (An
    # inverse-based matmul sandwich reusing the explicit W^-1 was tried for
    # speed — batched solves are latency-bound — but it degraded f32
    # NatGrad training: the 15k-step flagship soak diverged to a degenerate
    # state, train accuracy 1.0 -> 0.10.  The solves stay.)
    X = lax.linalg.triangular_solve(W, P, left_side=True, lower=True,
                                    transpose_a=True)        # W^-T P
    S_bar = lax.linalg.triangular_solve(W, X, left_side=False, lower=True)
    S_bar = 0.5 * (S_bar + jnp.swapaxes(S_bar, -1, -2))
    eta1_bar = dmu - 2.0 * jnp.einsum('rmn,rn->rm', S_bar, mu)
    return eta1_bar, S_bar


def _meanvarsqrt_to_expectation(mu, W):
    S = jnp.matmul(W, jnp.swapaxes(W, -1, -2))
    return mu, S + mu[:, :, None] * mu[:, None, :]


def _meanvarsqrt_to_natural(mu, W):
    """theta1 = S^-1 mu, theta2 = -1/2 S^-1 (via Cholesky solves)."""
    M = W.shape[-1]
    I = jnp.broadcast_to(jnp.eye(M, dtype=W.dtype), W.shape)
    Winv = lax.linalg.triangular_solve(W, I, left_side=True, lower=True)
    Sinv = jnp.matmul(jnp.swapaxes(Winv, -1, -2), Winv)
    theta1 = jnp.einsum('rmn,rn->rm', Sinv, mu)
    return theta1, -0.5 * Sinv


def _natural_to_meanvarsqrt(theta1, theta2):
    """(theta1, theta2) -> (mu = S theta1, W = chol(S)) with S = P^-1,
    P = -2 theta2.

    chol(P^-1) is obtained directly from ONE factorization via the exchange
    identity: with J the index-reversal and Lf = chol(J P J),
        P^-1 = (J Lf^-T J)(J Lf^-T J)^T  and  J Lf^-T J is lower-triangular
    with positive diagonal — i.e. W = J Lf^-T J IS the Cholesky factor of S.
    The naive route (chol(P), invert, re-chol(S)) costs two blocked batched
    Choleskys; this costs one plus a triangular inverse, and batched
    factorizations are the latency wall of the NatGrad step.
    """
    P = -2.0 * theta2                       # = S^-1
    Pf = P[..., ::-1, ::-1]                 # J P J
    Lf = jnp.linalg.cholesky(Pf)
    M = P.shape[-1]
    I = jnp.broadcast_to(jnp.eye(M, dtype=P.dtype), P.shape)
    Lfinv = lax.linalg.triangular_solve(Lf, I, left_side=True, lower=True)
    W = jnp.swapaxes(Lfinv, -1, -2)[..., ::-1, ::-1]   # J Lf^-T J, lower
    S = jnp.matmul(W, jnp.swapaxes(W, -1, -2))
    mu = jnp.einsum('rmn,rn->rm', S, theta1)
    return mu, W


def natgrad_update(q_mu, q_sqrt, dq_mu, dq_sqrt, gamma):
    """One natural-gradient step for a single layer.

    q_mu [M, R], q_sqrt [R, M, M] (lower triangle meaningful); d* are the
    (reverse-mode) loss gradients w.r.t. them.  Returns proposed new values
    (possibly containing NaN if the implied covariance loses positive
    definiteness — caller handles backoff).

    The theta-space round trip collapses analytically.  With
    H = sym(phi(W^T dW)) (so the expectation pullback is
    S_bar = W^-T H W^-1, ``_expectation_vjp``) and G = I + 2*gamma*H:

        P_new = -2 theta2' = Sinv + 2g S_bar = W^-T G W^-1
        S_new = P_new^-1   = W G^-1 W^T
        mu_new = S_new theta1' = S_new (P_new mu - g dmu) = mu - g S_new dmu

    and chol(S_new) needs NO new factorization beyond chol of (flipped) G:
    with J the index reversal and U = J chol(J G J)^-T J — lower-triangular
    with positive diagonal, the exchange identity gives G^-1 = U U^T — the
    product W U is lower-triangular (exactly: its upper entries are sums of
    products each containing a structural zero) with positive diagonal and
    (W U)(W U)^T = S_new, i.e.  W_new = W U *is* the Cholesky factor.

    Total per step: ONE batched Cholesky + ONE batched triangular solve
    (the M-rhs inverse of Lgf) + triangular matmuls — versus one Cholesky
    plus FOUR batched solves for the explicit theta round trip.
    Numerically the fused form is the better-conditioned one as well:
    G = I + O(gamma) while the old path factorized P = Sinv + 2g S_bar
    with Sinv = W^-T W^-1 formed explicitly (condition squared).  The
    triangular products run at ``_STATE_PRECISION``: their result is the
    new Cholesky factor itself, so a TF32 product would feed visible
    rounding back into the variational state every step.  Equality with
    the textbook transform is
    pinned by test_training.py::test_natgrad_matches_theta_roundtrip and
    the NatGrad trajectory-parity suite.
    """
    mu = q_mu.T                                  # [R, M]
    W = jnp.tril(q_sqrt)                          # [R, M, M]
    dmu = dq_mu.T
    dW = jnp.tril(dq_sqrt)

    XtW = jnp.matmul(jnp.swapaxes(W, -1, -2), dW)  # X = W^T dW
    M = W.shape[-1]
    # The exchange-identity factor in UPPER form: G = R R^T with R
    # upper-triangular gives U = R^-T — lower-triangular with positive
    # diagonal and U U^T = G^-1 — so W_new = W R^-T directly.  Lower
    # Cholesky of the index-reversed G (which reads the full symmetric
    # matrix), then R^-1 = J Lgf^-1 J (flip both axes, no transpose); the
    # final transpose is absorbed into the dot_general's contracting dims.
    P = _phi(XtW)
    H = 0.5 * (P + jnp.swapaxes(P, -1, -2))  # sym(phi(W^T dW))
    G = 2.0 * gamma * H + jnp.eye(M, dtype=W.dtype)
    Lgf = jnp.linalg.cholesky(G[..., ::-1, ::-1])
    I = jnp.broadcast_to(jnp.eye(M, dtype=W.dtype), W.shape)
    Lgfinv = lax.linalg.triangular_solve(Lgf, I, left_side=True, lower=True)
    Rinv = Lgfinv[..., ::-1, ::-1]
    W_new = jnp.einsum('rmk,rnk->rmn', W, Rinv,
                       precision=_STATE_PRECISION)         # W R^-T
    # mu_new = mu - g W_new (W_new^T dmu): two matvecs, no S_new needed.
    t = jnp.einsum('rmn,rm->rn', W_new, dmu,
                   precision=_STATE_PRECISION)                # W_new^T dmu
    mu_new = mu - gamma * jnp.einsum('rmn,rn->rm', W_new, t,
                                     precision=_STATE_PRECISION)
    return mu_new.T, W_new


def natgrad_update_theta(q_mu, q_sqrt, dq_mu, dq_sqrt, gamma):
    """The explicit theta-space round trip (Salimbeni et al. XiNat):
    reference implementation used as the oracle for the fused
    ``natgrad_update`` above (kept out of the hot path)."""
    mu = q_mu.T
    W = jnp.tril(q_sqrt)
    dmu = dq_mu.T
    dW = jnp.tril(dq_sqrt)

    # dL/deta: VJP through eta -> (mu, chol(S)).  chol(S) == W by
    # construction, so the pullback runs chol-free (_expectation_vjp).
    deta1, deta2 = _expectation_vjp(mu, W, dmu, dW)

    theta1, theta2 = _meanvarsqrt_to_natural(mu, W)
    theta1 = theta1 - gamma * deta1
    theta2 = theta2 - gamma * deta2

    mu_new, W_new = _natural_to_meanvarsqrt(theta1, theta2)
    return mu_new.T, W_new


def natgrad_step_with_backoff(layers: tuple, grads_layers: tuple, gamma,
                              steps_back):
    """Apply natgrad to every layer's (q_mu, q_sqrt); on any non-finite
    result, keep ALL old values and bump ``steps_back``
    (the jit-friendly equivalent of `conv_gp/experiment.py:38-49`).

    Layers with the same (M, R) are STACKED along the GP axis and updated
    by one batched ``natgrad_update`` call: the update is independent per
    GP, so the flagship config's two identical-(M, R) layers share one
    batched factorization instead of two."""
    groups = {}  # (q_mu.shape, q_sqrt.shape) -> list of layer indices
    for i, layer in enumerate(layers):
        groups.setdefault(
            (layer.q_mu.shape, layer.q_sqrt.shape), []).append(i)

    proposals = [None] * len(layers)
    for key, idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            proposals[i] = natgrad_update(
                layers[i].q_mu, layers[i].q_sqrt,
                grads_layers[i].q_mu, grads_layers[i].q_sqrt, gamma)
        else:
            q_mu = jnp.concatenate([layers[i].q_mu for i in idxs], axis=1)
            q_sqrt = jnp.concatenate([layers[i].q_sqrt for i in idxs],
                                     axis=0)
            dmu = jnp.concatenate([grads_layers[i].q_mu for i in idxs],
                                  axis=1)
            dsq = jnp.concatenate([grads_layers[i].q_sqrt for i in idxs],
                                  axis=0)
            mu_new, W_new = natgrad_update(q_mu, q_sqrt, dmu, dsq, gamma)
            off = 0
            for i in idxs:
                r = layers[i].q_mu.shape[1]
                proposals[i] = (mu_new[:, off:off + r],
                                W_new[off:off + r])
                off += r

    finite = jnp.asarray(True)
    for mu_new, W_new in proposals:
        finite = jnp.logical_and(finite, jnp.all(jnp.isfinite(mu_new)))
        finite = jnp.logical_and(finite, jnp.all(jnp.isfinite(W_new)))

    new_layers = tuple(
        layer.replace(
            q_mu=jnp.where(finite, mu_new, layer.q_mu),
            q_sqrt=jnp.where(finite, W_new, jnp.tril(layer.q_sqrt)))
        for layer, (mu_new, W_new) in zip(layers, proposals))
    new_steps_back = jnp.where(finite, steps_back, steps_back + 1.0)
    return new_layers, new_steps_back, finite
