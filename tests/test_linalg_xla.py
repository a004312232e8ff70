"""The XLA linear-algebra routes of the conditional and NatGrad, at the
benchmark widths: ``linalg.chol_with_inv`` (value and custom VJP) against
numpy/scipy and JAX's own Cholesky VJP, the flipped-lower factor that
NatGrad uses as its upper factor, and the fused NatGrad update against the
explicit theta round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import solve_triangular

from deepcgp_tpu.ops import linalg
from deepcgp_tpu.training import optim

# (batch, M): 0 = an unbatched [M, M] matrix.  Conditional Kuu stacks up to
# the flagship's [3, 384, 384], NatGrad's batched factors, and the m1024
# [1024, 1024] factor.
SHAPES = [(5, 128), (5, 256), (5, 384), (1, 64), (3, 384), (2, 192),
          (0, 128), (0, 384), (20, 64), (0, 512), (3, 512), (0, 1024),
          (2, 128), (2, 512), (1, 1024)]


def _spd(rng, batch, M, jitter=2.0):
    A = rng.randn(max(batch, 1), M, M)
    S = A @ np.swapaxes(A, -1, -2) / M + jitter * np.eye(M)
    return S if batch else S[0]


@pytest.mark.parametrize('batch,M', SHAPES)
def test_chol_with_inv_matches_numpy(batch, M):
    S = _spd(np.random.RandomState(M + batch), batch, M)
    L, Linv = linalg.chol_with_inv(jnp.asarray(S))
    ref = np.linalg.cholesky(S)
    np.testing.assert_allclose(np.asarray(L), ref, rtol=1e-9, atol=1e-11)
    refinv = np.linalg.inv(ref)
    np.testing.assert_allclose(np.asarray(Linv), refinv, rtol=1e-8,
                               atol=1e-10)
    # Strictly lower triangular: exact zeros above the diagonal.
    assert (np.triu(np.asarray(L), 1) == 0).all()
    assert (np.triu(np.asarray(Linv), 1) == 0).all()


@pytest.mark.parametrize('batch,M', SHAPES)
def test_chol_with_inv_vjp_matches_autodiff(batch, M):
    """The matmul-only custom VJP equals JAX's own Cholesky VJP composed
    with a triangular solve, for cotangents on both outputs."""
    rng = np.random.RandomState(M + 7 * batch)
    K = jnp.asarray(_spd(rng, batch, M))
    gL = jnp.asarray(np.tril(rng.randn(*K.shape)))
    gLinv = jnp.asarray(np.tril(rng.randn(*K.shape)))

    def plain(K):
        L = jnp.linalg.cholesky(K)
        eye = jnp.broadcast_to(jnp.eye(M, dtype=K.dtype), K.shape)
        return L, jax.lax.linalg.triangular_solve(L, eye, left_side=True,
                                                  lower=True)

    _, vjp = jax.vjp(linalg.chol_with_inv, K)
    _, vjp_ref = jax.vjp(plain, K)
    got, = vjp((gL, gLinv))
    want, = vjp_ref((gL, gLinv))
    # JAX's Cholesky VJP returns a symmetrized cotangent, as ours does.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-7, atol=1e-9 * float(
                                   np.abs(np.asarray(want)).max()))


FLIP_SHAPES = [(5, 128), (5, 384), (3, 64), (2, 256), (20, 64), (1, 512)]


@pytest.mark.parametrize('batch,M', FLIP_SHAPES)
def test_flipped_lower_factor_is_upper_factor(batch, M):
    """NatGrad's exchange identity: R = J chol(J A J) J is upper-triangular
    with R R^T = A, and J chol(J A J)^-1 J = R^-1."""
    A = _spd(np.random.RandomState(3 * M + batch), batch, M)
    Lf, Lfinv = linalg.chol_with_inv(jnp.asarray(A[..., ::-1, ::-1]))
    R = np.asarray(Lf)[..., ::-1, ::-1]
    Rinv = np.asarray(Lfinv)[..., ::-1, ::-1]
    assert (np.tril(R, -1) == 0).all()
    assert (np.tril(Rinv, -1) == 0).all()
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), A,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Rinv @ R,
                               np.broadcast_to(np.eye(M), R.shape),
                               atol=1e-9)
    # Y R^T = X by back-substitution equals X R^-T (the NatGrad W_new).
    X = np.random.RandomState(M).randn(batch, 7, M)
    Y = np.stack([solve_triangular(R[b], X[b].T, lower=False).T
                  for b in range(batch)])
    np.testing.assert_allclose(X @ np.swapaxes(Rinv, -1, -2), Y,
                               rtol=1e-8, atol=1e-8)


def _natgrad_inputs(rng, R, M, dirty: bool):
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) / M + 5.0 * np.eye(M)
    q_sqrt = np.linalg.cholesky(S)
    dq_sqrt = rng.randn(R, M, M)
    if dirty:
        # Garbage above the diagonal: only the lower triangles are state.
        q_sqrt = q_sqrt + np.triu(rng.randn(R, M, M) * 1e3, 1)
    return q_sqrt, rng.randn(M, R), rng.randn(M, R), dq_sqrt


@pytest.mark.parametrize('dirty', [False, True])
@pytest.mark.parametrize('R,M', [(3, 64), (3, 384), (3, 256)])
def test_natgrad_update_matches_theta_roundtrip(R, M, dirty):
    """The fused XLA NatGrad update equals the explicit theta-space round
    trip, and ignores whatever sits above q_sqrt's diagonal."""
    rng = np.random.RandomState(M + R)
    q_sqrt, q_mu, dq_mu, dq_sqrt = _natgrad_inputs(rng, R, M, dirty)
    for gamma in (1e-3, 1e-2):
        mu_f, W_f = optim.natgrad_update(q_mu, q_sqrt, dq_mu, dq_sqrt, gamma)
        mu_t, W_t = optim.natgrad_update_theta(q_mu, np.tril(q_sqrt), dq_mu,
                                               dq_sqrt, gamma)
        assert np.isfinite(np.asarray(W_f)).all(), gamma
        assert (np.triu(np.asarray(W_f), 1) == 0).all()
        np.testing.assert_allclose(np.asarray(mu_f), np.asarray(mu_t),
                                   rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(np.asarray(W_f), np.asarray(W_t),
                                   rtol=1e-8, atol=1e-9)
