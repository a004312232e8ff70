"""Linear-algebra primitives for sparse variational GP layers.

Replacements for the reference's TF linalg surface
(`conv_gp/conditionals.py:29-47`, `conv_gp/layers.py:137-158`):

* jittered Cholesky (reference adds jitter at Kuu construction,
  `conv_gp/layers.py:18-21`);
* many-right-hand-side triangular solves replacing the per-patch
  ``tf.map_fn(tf.matrix_triangular_solve)`` loops
  (`conv_gp/conditionals.py:31-33,44-47`) with a single large solve;
* ``gauss_kl`` replacing gpflow's (`conv_gp/layers.py:137-147` call site).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import lax

from deepcgp_tpu.config import settings


def add_jitter(K: jax.Array, jitter: float | None = None) -> jax.Array:
    """K + jitter * I on the last two dims."""
    if jitter is None:
        jitter = settings.jitter
    M = K.shape[-1]
    return K + jitter * jnp.eye(M, dtype=K.dtype)


def cholesky(K: jax.Array) -> jax.Array:
    """Lower Cholesky. JAX returns NaN (not an exception) on failure; callers
    that need the reference's retry behaviour (`conv_gp/experiment.py:38-49`)
    check for NaNs instead of catching errors."""
    return jnp.linalg.cholesky(K)


def jittered_cholesky(K: jax.Array, jitter: float | None = None) -> jax.Array:
    return cholesky(add_jitter(K, jitter))


def solve_triangular_mrhs(L: jax.Array, B: jax.Array, *, lower: bool = True,
                          trans: bool = False) -> jax.Array:
    """Solve ``op(L) X = B`` where B may have arbitrary batch dims *behind*
    the matrix dim: B has shape [..., M, N] with a single shared L [M, M].

    The reference loops a triangular solve over the patch axis with
    ``tf.map_fn`` (`conv_gp/conditionals.py:31-33`).  Here all batch axes are
    folded into one wide right-hand side so the device sees one big solve.
    """
    M = L.shape[-1]
    batch_shape = B.shape[:-2]
    N = B.shape[-1]
    if batch_shape:
        # [..., M, N] -> [M, prod(batch)*N]
        B2 = jnp.moveaxis(B, -2, 0).reshape(M, -1)
    else:
        B2 = B
    X2 = lax.linalg.triangular_solve(
        L, B2, left_side=True, lower=lower, transpose_a=trans)
    if batch_shape:
        X = jnp.moveaxis(X2.reshape((M,) + batch_shape + (N,)), 0, -2)
    else:
        X = X2
    return X


# Precision of every matmul that APPLIES a triangular inverse, and of the
# chol_with_inv custom-VJP matmuls.  On the H100 both DEFAULT and HIGH run a
# float32 product as TF32 (10-bit mantissa, ~1e-3 relative error); HIGHEST
# is the full-float32 product.  Round 1 showed that inverse applies at
# ~1e-3 relative error, amplified by the factor's condition number, make
# float32 training produce NaN, so these stay at float32 accuracy.
# DEEPCGP_INV_PRECISION / DEEPCGP_CHOL_VJP_PRECISION override them.
_PRECISIONS = {
    'default': lax.Precision.DEFAULT,
    'high': lax.Precision.HIGH,
    'highest': lax.Precision.HIGHEST,
}
_INV_PRECISION = _PRECISIONS[os.environ.get('DEEPCGP_INV_PRECISION',
                                            'highest')]
_CHOL_VJP_PRECISION = _PRECISIONS[os.environ.get('DEEPCGP_CHOL_VJP_PRECISION',
                                                 'highest')]


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.einsum('...ij,...jk->...ik',
                      a, b, precision=_CHOL_VJP_PRECISION)


def _chol_inv_impl(K: jax.Array):
    """(chol(K), chol(K)^-1) for K [..., M, M] SPD: XLA's Cholesky plus one
    M-rhs triangular solve against the identity.  Both give NaN on a non-PD
    input, so callers' finite checks keep working."""
    L = jnp.linalg.cholesky(K)
    eye = jnp.broadcast_to(jnp.eye(K.shape[-1], dtype=K.dtype), K.shape)
    Linv = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return L, Linv


@jax.custom_vjp
def chol_with_inv(K: jax.Array):
    """Differentiable (L, L^-1) of an SPD K — the conditional's wide
    triangular-solve chains (`conv_gp/conditionals.py:31-47`) become plain
    matmuls against L^-1, and this custom VJP keeps the BACKWARD free
    of triangular-solve custom calls too: with L^-1 in hand, the Cholesky
    reverse is pure matmuls,

        Kbar = sym(L^-T . Phi(L^T Lbar) . L^-1),
        Lbar += -L^-T gLinv L^-T   (cotangent of the inverse),

    with Phi = tril with halved diagonal (the adjoint of the Cholesky
    jvp's projector).  Pinned exactly against plain autodiff in
    tests/test_numerics_core.py."""
    return _chol_inv_impl(K)


def _chol_with_inv_fwd(K):
    out = _chol_inv_impl(K)
    return out, out


def _chol_with_inv_bwd(res, cots):
    L, Linv = res
    gL, gLinv = cots
    T = lambda x: jnp.swapaxes(x, -1, -2)  # noqa: E731
    Lbar = jnp.tril(gL - _mm(_mm(T(Linv), gLinv), T(Linv)))
    P = _mm(T(L), Lbar)
    eye = jnp.eye(L.shape[-1], dtype=L.dtype)
    Phi = jnp.tril(P) - 0.5 * (P * eye)
    Kbar = _mm(_mm(T(Linv), Phi), Linv)
    return (0.5 * (Kbar + T(Kbar)),)


chol_with_inv.defvjp(_chol_with_inv_fwd, _chol_with_inv_bwd)


def _diag_part(A: jax.Array) -> jax.Array:
    """[..., M, M] -> [..., M] diagonal via an eye-masked reduce — a single
    bandwidth-bound fusion; jnp.diagonal lowers to a gather whose BACKWARD
    is a scatter-add into a fresh [..., M, M] plus a layout copy."""
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    return jnp.sum(A * eye, axis=-1)


@jax.custom_vjp
def tril_logdet(L: jax.Array) -> jax.Array:
    """sum(log|diag(L)|) over every leading batch dim of a triangular
    factor stack [..., M, M] — i.e. half the log-determinant sum.

    Why custom_vjp: the masked-elementwise-log form
    ``sum(log(L*eye + (1-eye)))`` (round 2) keeps the gradient fusable but
    materializes the full [..., M, M] masked matrix as the backward
    residual — at M=1024 that is a 42MB write in forward plus a 42MB read
    in backward.  Only the
    DIAGONAL is mathematically live in either direction: forward saves the
    [..., M] diagonal, backward broadcasts (g / diag) onto the diagonal —
    an eye-broadcast fusion that folds into the surrounding gradient
    accumulation."""
    return jnp.sum(jnp.log(jnp.abs(_diag_part(L))))


def _tril_logdet_fwd(L):
    d = _diag_part(L)
    return jnp.sum(jnp.log(jnp.abs(d))), d


def _tril_logdet_bwd(d, g):
    eye = jnp.eye(d.shape[-1], dtype=d.dtype)
    return ((g / d)[..., None] * eye,)


tril_logdet.defvjp(_tril_logdet_fwd, _tril_logdet_bwd)


@jax.custom_vjp
def syrk_sum(Lq: jax.Array) -> jax.Array:
    """T = sum_r Lq_r Lq_r^T as ONE dot_general contracting over (r, k):
    einsum('rmk,rnk->mn').

    Why custom_vjp: autodiff treats the two einsum operands as independent
    and emits TWO full-size backward einsums (dLq1 = C Lq summing n,
    dLq2 = C^T Lq summing m) that are then added — 2x 2*R*M^3 flops.  The
    operands are the SAME tensor, so the exact cotangent collapses to
        dLq = (C + C^T) Lq
    — one einsum against the (cheap, M^2) symmetrized cotangent, half the
    backward arithmetic.  Exactness vs autodiff is
    pinned by test_numerics_core.py::test_syrk_sum_vjp."""
    return jnp.einsum('rmk,rnk->mn', Lq, Lq)


def _syrk_sum_fwd(Lq):
    return syrk_sum(Lq), Lq


def _syrk_sum_bwd(Lq, C):
    Csym = C + C.T
    return (jnp.einsum('mn,rnk->rmk', Csym, Lq),)


syrk_sum.defvjp(_syrk_sum_fwd, _syrk_sum_bwd)


@jax.custom_vjp
def gram_syrk(X: jax.Array) -> jax.Array:
    """G = X X^T over the last two dims ([..., N, D] -> [..., N, N]) with a
    Cholesky-safe FORWARD and a cheap, single-matmul BACKWARD.

    Forward runs at Precision.HIGHEST: these grams become Kuu/Kff matrices
    whose factorizations must stay positive definite (a TF32 product's
    ~1e-3 relative error swamps the jitter — see
    :func:`deepcgp_tpu.ops.distances.square_distance`).

    Backward: autodiff of ``matmul(X, X^T)`` emits TWO full-size matmuls
    (dX = C X + C^T X).  The operands are the SAME tensor, so the exact
    cotangent is ONE matmul against the symmetrized cotangent,

        dX = (C + C^T) X,

    at the chol_with_inv VJP precision.  Exactness of the collapsed
    cotangent vs plain autodiff is pinned by
    test_numerics_core.py::test_gram_syrk_vjp."""
    return jnp.einsum('...nd,...md->...nm', X, X,
                      precision=lax.Precision.HIGHEST)


def _gram_syrk_fwd(X):
    return gram_syrk(X), X


def _gram_syrk_bwd(X, C):
    Csym = C + jnp.swapaxes(C, -1, -2)
    return (jnp.einsum('...nm,...md->...nd', Csym, X,
                       precision=_CHOL_VJP_PRECISION),)


gram_syrk.defvjp(_gram_syrk_fwd, _gram_syrk_bwd)


def gauss_kl(q_mu: jax.Array, q_sqrt: jax.Array,
             K: jax.Array | None = None, *,
             Lp: jax.Array | None = None,
             Lp_inv: jax.Array | None = None) -> jax.Array:
    """KL[q(u) || p(u)] summed over independent GPs.

    Matches gpflow 1.x ``gauss_kl`` as used at `conv_gp/layers.py:137-147`:

    * ``q_mu``: [M, R] variational means.
    * ``q_sqrt``: [R, M, M]; only the lower triangle is used (the reference
      stores it under a LowerTriangular transform, `conv_gp/layers.py:85-91`).
    * ``K``: shared [M, M] prior covariance, or None for a whitened
      (identity) prior.  ``Lp`` optionally supplies its precomputed
      Cholesky (layers reuse the per-step cache instead of refactorizing).

    KL = 0.5 * sum_r [ tr(K^-1 S_r) + m_r^T K^-1 m_r - M
                       - logdet(S_r) + logdet(K) ].
    """
    M, R = q_mu.shape
    Lq = jnp.tril(q_sqrt)  # [R, M, M]
    # R is the model-parallel axis of the variational stacks (see
    # ops/conditional.py q_sqrt-term note): under a mesh the KL's syrk /
    # logdet work shards over 'model' and GSPMD psums the scalar.
    from deepcgp_tpu.parallel import sharding
    Lq = sharding.constrain(Lq, 'model', None, None)

    if K is None and Lp is None and Lp_inv is None:
        alpha = q_mu  # K^-1 m = m
        trace = jnp.sum(jnp.square(Lq))
        logdet_prior = jnp.zeros((), dtype=q_mu.dtype)
    elif Lp_inv is not None:
        assert Lp is not None, "Lp_inv requires its factor Lp (for logdet)"
        # Inverse-matmul form (cache built by linalg.chol_with_inv): the
        # trace term tr(K^-1 T) = <Lp^-T Lp^-1, T> and the Mahalanobis
        # solve both become inverse-apply-precision matmuls — no
        # triangular-solve custom call in forward OR backward (the VJP of
        # an einsum is einsums; Lp_inv's own backward is the matmul-only
        # chol_with_inv VJP).
        T_ = syrk_sum(Lq)                                    # [M, M]
        W = jnp.einsum('km,kn->mn', Lp_inv, Lp_inv,
                       precision=_INV_PRECISION)             # Lp^-T Lp^-1
        trace = jnp.sum(W * T_)
        alpha = jnp.einsum('mk,kr->mr', Lp_inv, q_mu,
                           precision=_INV_PRECISION)         # Lp^-1 m
        logdet_prior = R * 2.0 * tril_logdet(Lp)
    else:
        if Lp is None:
            Lp = cholesky(K)  # [M, M]
        # sum_r tr(K^-1 S_r) = tr(K^-1 T) with T = sum_r Lq_r Lq_r^T,
        # computed as tr(solve(Lp^T, solve(Lp, T))).  Equivalent to
        # ||Lp^-1 Lq||_F^2 summed over r, but the R-fold work moves from an
        # R*M-rhs triangular solve (whose VJP is ANOTHER R*M-rhs solve) into
        # one matmul contraction; the remaining solves carry M rhs each,
        # independent of R.
        #
        # T is ONE dot_general contracting over (r, k): a reshape-to-
        # [M, R*M] matmul form materializes a layout copy of the stack in
        # both directions.
        T = syrk_sum(Lq)                                     # [M, M]
        # The Mahalanobis solve rides the SAME triangular-solve call as the
        # trace term (T first; the R-column q_mu tail is tiny) — one
        # [M, M+R]-rhs call beats an [M, M] plus an [M, R] call, and its
        # VJP is likewise one solve instead of two.
        V = lax.linalg.triangular_solve(
            Lp, jnp.concatenate([T, q_mu], axis=1),
            left_side=True, lower=True)                      # [M, M+R]
        alpha = V[:, M:]                                     # Lp^-1 m
        X = lax.linalg.triangular_solve(Lp, V[:, :M], left_side=True,
                                        lower=True, transpose_a=True)
        trace = jnp.trace(X)
        logdet_prior = R * 2.0 * tril_logdet(Lp)

    mahalanobis = jnp.sum(jnp.square(alpha))
    # Diagonal-residual logdet (see tril_logdet): only the [R, M] diagonal
    # is live in forward or backward; q_sqrt is passed directly since tril
    # does not touch the diagonal.
    logdet_q = 2.0 * tril_logdet(q_sqrt)
    constant = jnp.asarray(M * R, dtype=q_mu.dtype)
    return 0.5 * (trace + mahalanobis - constant - logdet_q + logdet_prior)
