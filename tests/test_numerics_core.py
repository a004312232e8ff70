"""Oracle-parity tests for the numerics core (SURVEY.md §7 stage 1-2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from deepcgp_tpu.models.base_kernels import RBF, ArcCosine
from deepcgp_tpu.ops import linalg
from deepcgp_tpu.ops.conditional import multi_output_conditional
from deepcgp_tpu.ops.patches import extract_patches, extract_patches_conv
from deepcgp_tpu.models.views import FullView, RandomPartialView

RNG = np.random.RandomState(0)


def test_rbf_matches_oracle_scalar_and_ard():
    X = RNG.randn(7, 5)
    X2 = RNG.randn(4, 5)
    k = RBF.create(variance=5.0, lengthscales=5.0, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(k.K(X, X2)),
                               oracle.rbf_K(5.0, 5.0, X, X2), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(k.K(X)),
                               oracle.rbf_K(5.0, 5.0, X), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(k.Kdiag(X)),
                               np.full(7, 5.0), rtol=1e-9)
    ls = RNG.rand(5) + 0.5
    k2 = RBF.create(variance=2.0, lengthscales=ls, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(k2.K(X, X2)),
                               oracle.rbf_K(2.0, ls, X, X2), rtol=1e-9)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_arccosine_matches_oracle(order):
    X = RNG.randn(6, 4)
    X2 = RNG.randn(5, 4)
    k = ArcCosine.create(variance=1.7, weight_variances=1.3,
                         bias_variance=0.8, order=order, dtype=jnp.float64)
    np.testing.assert_allclose(
        np.asarray(k.K(X, X2)),
        oracle.arccosine_K(1.7, 1.3, 0.8, order, X, X2), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(k.Kdiag(X)),
        np.diag(oracle.arccosine_K(1.7, 1.3, 0.8, order, X)), rtol=1e-7)


def _random_spd(M):
    A = RNG.randn(M, M)
    return A @ A.T + M * np.eye(M)


def test_solve_triangular_mrhs_batched():
    M, P, N = 8, 5, 3
    L = np.linalg.cholesky(_random_spd(M))
    B = RNG.randn(P, M, N)
    X = np.asarray(linalg.solve_triangular_mrhs(jnp.asarray(L), jnp.asarray(B)))
    for p in range(P):
        np.testing.assert_allclose(L @ X[p], B[p], atol=1e-10)
    Xt = np.asarray(linalg.solve_triangular_mrhs(
        jnp.asarray(L), jnp.asarray(B), trans=True))
    for p in range(P):
        np.testing.assert_allclose(L.T @ Xt[p], B[p], atol=1e-10)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("full_cov", [False, True])
def test_conditional_matches_oracle(white, full_cov):
    P, M, N, R = 6, 9, 4, 3
    Kmm = _random_spd(M)
    Kmn = RNG.randn(P, M, N)
    if full_cov:
        Knn = np.stack([_random_spd(N) for _ in range(P)])
    else:
        Knn = RNG.rand(P, N) + 1.0
    f = RNG.randn(M, R)
    q_sqrt = np.tril(RNG.randn(R, M, M)) + 2 * np.eye(M)

    got_mean, got_var = multi_output_conditional(
        jnp.asarray(Kmn), jnp.asarray(Kmm), jnp.asarray(Knn), jnp.asarray(f),
        full_cov=full_cov, q_sqrt=jnp.asarray(q_sqrt), white=white)
    want_mean, want_var = oracle.conditional(
        Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)
    np.testing.assert_allclose(np.asarray(got_mean), want_mean, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got_var), want_var, atol=1e-8)


def test_conditional_no_qsqrt_and_precomputed_Lm():
    P, M, N, R = 3, 7, 5, 2
    Kmm = _random_spd(M)
    Kmn = RNG.randn(P, M, N)
    Knn = RNG.rand(P, N) + 1.0
    f = RNG.randn(M, R)
    want_mean, want_var = oracle.conditional(Kmn, Kmm, Knn, f)
    Lm = jnp.linalg.cholesky(jnp.asarray(Kmm))
    got_mean, got_var = multi_output_conditional(
        jnp.asarray(Kmn), None, jnp.asarray(Knn), jnp.asarray(f), Lm=Lm)
    np.testing.assert_allclose(np.asarray(got_mean), want_mean, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got_var), want_var, atol=1e-8)


def test_conditional_diag_variance_clamped_nonnegative():
    """The diagonal Knn - ||A||^2 must be clamped at 0: in f32 the
    inverse-apply matmul noise exceeds a tiny true posterior variance when
    Kmm is ill-conditioned (near-duplicate inducing patches), and the
    resulting negative variance NaN'd sqrt(var) in sampling (observed on
    the UCI-digits 2-layer config; exact arithmetic gives +9e-4 there).
    Doctored inputs force the subtraction negative in exact arithmetic too:
    Kmm = I (so A == Kmn row form) and Knn slightly below ||A||^2."""
    P, M, N = 2, 4, 3
    Kmn = RNG.randn(P, M, N)
    a2 = np.sum(np.square(Kmn), axis=1)                    # [P, N] = ||A||^2
    Knn = a2 - 1e-6                                        # negative by 1e-6
    f = np.zeros((M, 1))
    _, got_var = multi_output_conditional(
        jnp.asarray(Kmn), jnp.asarray(np.eye(M)), jnp.asarray(Knn),
        jnp.asarray(f))
    got_var = np.asarray(got_var)
    assert np.isfinite(got_var).all()
    assert (got_var >= 0.0).all()
    # Healthy variances are untouched by the clamp.
    Knn_ok = a2 + 0.5
    _, var_ok = multi_output_conditional(
        jnp.asarray(Kmn), jnp.asarray(np.eye(M)), jnp.asarray(Knn_ok),
        jnp.asarray(f))
    np.testing.assert_allclose(np.asarray(var_ok)[0], 0.5, atol=1e-8)


def test_conditional_full_cov_diag_clamped_nonnegative():
    """Full-cov twin of the diag clamp: the same f32
    downdate noise sits on the diagonal of the [N, N] posterior covariance,
    and sample_from_conditional(full_cov=True) Choleskys that matrix — a
    negative diagonal NaNs it.  Same doctored construction as the diag
    test: Kmm = I makes A == Kmn (row form), and Knn is built so its
    diagonal sits slightly BELOW the A A^T downdate's while off-diagonals
    stay untouched."""
    P, M, N = 2, 4, 3
    Kmn = RNG.randn(P, M, N)
    AAt = np.einsum('pmn,pmk->pnk', Kmn, Kmn)              # [P, N, N]
    Knn = AAt.copy()
    eye = np.eye(N)
    Knn -= 1e-6 * eye                                      # diag negative
    Knn += 0.3 * (1 - eye)                                 # off-diag offset
    f = np.zeros((M, 1))
    _, got_var = multi_output_conditional(
        jnp.asarray(Kmn), jnp.asarray(np.eye(M)), jnp.asarray(Knn),
        jnp.asarray(f), full_cov=True)
    got_var = np.asarray(got_var)                          # [R, P, N, N]
    assert np.isfinite(got_var).all()
    diag = np.diagonal(got_var, axis1=-2, axis2=-1)
    assert (diag >= 0.0).all()
    # Off-diagonals carry the exact (unclamped) downdate value.
    offd = got_var[0] * (1 - eye)
    np.testing.assert_allclose(
        offd, np.broadcast_to(0.3 * (1 - eye), offd.shape), atol=1e-8)
    # Healthy diagonals are untouched by the clamp.
    _, var_ok = multi_output_conditional(
        jnp.asarray(Kmn), jnp.asarray(np.eye(M)),
        jnp.asarray(AAt + 0.5 * eye), jnp.asarray(f), full_cov=True)
    np.testing.assert_allclose(
        np.diagonal(np.asarray(var_ok)[0], axis1=-2, axis2=-1), 0.5,
        atol=1e-8)


def test_sample_from_conditional_full_cov_finite_on_ill_conditioned():
    """End-to-end guard: sampling with full_cov=True stays NaN-free on a
    layer whose Kmm is ill-conditioned (near-duplicate inducing inputs —
    the UCI-digits failure mode)."""
    from deepcgp_tpu.models.layers import SVGPLayer

    M, D = 8, 6
    Z = RNG.randn(M, D) * 0.01                 # near-duplicate inducing rows
    Z[1] = Z[0] + 1e-7
    Z[3] = Z[2] + 1e-7
    k = RBF.create(variance=1.0, lengthscales=1.0, dtype=jnp.float32)
    layer = SVGPLayer.create(k, Z, num_outputs=3, dtype=jnp.float32)
    X = RNG.randn(4, D).astype(np.float32) * 0.01
    sample, mean, var = layer.sample_from_conditional(
        jnp.asarray(X), jax.random.PRNGKey(0), full_cov=True)
    assert np.isfinite(np.asarray(sample)).all()
    assert np.isfinite(np.asarray(var)).all()


@pytest.mark.parametrize("use_K", [False, True])
def test_gauss_kl_matches_oracle(use_K):
    M, R = 10, 4
    q_mu = RNG.randn(M, R)
    q_sqrt = np.tril(RNG.randn(R, M, M)) + 2 * np.eye(M)
    K = _random_spd(M) if use_K else None
    got = linalg.gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt),
                          None if K is None else jnp.asarray(K))
    want = oracle.gauss_kl(q_mu, q_sqrt, K)
    np.testing.assert_allclose(float(got), want, rtol=1e-9)


@pytest.mark.parametrize("use_K", [False, True])
def test_gauss_kl_gradients_match_plain_autodiff(use_K):
    """The custom-VJP diagonal-residual logdet (linalg.tril_logdet) must
    produce gradients identical to plain autodiff of the masked-log form
    it replaced — pins the backward formula g/diag on the diagonal."""
    M, R = 9, 3
    q_mu = jnp.asarray(RNG.randn(M, R))
    q_sqrt = jnp.asarray(np.tril(RNG.randn(R, M, M)) + 2 * np.eye(M))
    K = jnp.asarray(_random_spd(M)) if use_K else None

    def plain_kl(q_mu, q_sqrt, K):
        Lq = jnp.tril(q_sqrt)
        eye = jnp.eye(M, dtype=q_sqrt.dtype)
        logdet_q = 2.0 * jnp.sum(jnp.log(jnp.abs(Lq * eye + (1.0 - eye))))
        if K is None:
            alpha, trace = q_mu, jnp.sum(jnp.square(Lq))
            logdet_p = jnp.zeros((), q_mu.dtype)
        else:
            Lp = jnp.linalg.cholesky(K)
            # ||Lp^-1 Lq_r||_F^2 summed over r, via an explicit loop.
            trace = sum(jnp.sum(jnp.square(jax.scipy.linalg.solve_triangular(
                Lp, Lq[r], lower=True))) for r in range(R))
            alpha = jax.scipy.linalg.solve_triangular(Lp, q_mu, lower=True)
            eye_p = jnp.eye(M, dtype=K.dtype)
            logdet_p = R * 2.0 * jnp.sum(jnp.log(jnp.abs(
                Lp * eye_p + (1.0 - eye_p))))
        return 0.5 * (trace + jnp.sum(jnp.square(alpha))
                      - M * R - logdet_q + logdet_p)

    args = (q_mu, q_sqrt) if K is None else (q_mu, q_sqrt, K)
    got = jax.grad(lambda *a: linalg.gauss_kl(*a), argnums=tuple(
        range(len(args))))(*args)
    want = jax.grad(lambda *a: plain_kl(*a, *(() if use_K else (None,))),
                    argnums=tuple(range(len(args))))(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("batched", [False, True])
def test_chol_with_inv_values_and_vjp(batched):
    """chol_with_inv must return (chol(K), chol(K)^-1) and its custom
    matmul-only VJP must equal plain autodiff through cholesky + solve.
    Gradients are compared THROUGH K = B B^T + c I so the comparison is
    insensitive to the symmetrization convention of the K cotangent."""
    import jax.scipy.linalg as jsl
    M = 12
    shape = (3, M, M) if batched else (M, M)
    B0 = jnp.asarray(RNG.randn(*shape))

    def makeK(B):
        return jnp.einsum('...ij,...kj->...ik', B, B) \
            + 2.0 * jnp.eye(M, dtype=B.dtype)

    def ref_pair(K):
        L = jnp.linalg.cholesky(K)
        eye = jnp.broadcast_to(jnp.eye(M, dtype=K.dtype), K.shape)
        Linv = jax.lax.linalg.triangular_solve(
            L, eye, left_side=True, lower=True)
        return L, Linv

    L, Linv = linalg.chol_with_inv(makeK(B0))
    Lr, Linvr = ref_pair(makeK(B0))
    np.testing.assert_allclose(np.asarray(L), np.asarray(Lr), atol=1e-12)
    np.testing.assert_allclose(np.asarray(Linv), np.asarray(Linvr),
                               atol=1e-11)
    # Inverse really inverts.
    prod = jnp.einsum('...ij,...jk->...ik', Linv, L)
    np.testing.assert_allclose(
        np.asarray(prod),
        np.broadcast_to(np.eye(M), prod.shape), atol=1e-11)

    def loss(pair_fn, B):
        L, Li = pair_fn(makeK(B))
        return jnp.sum(jnp.sin(L)) + jnp.sum(jnp.cos(0.3 * Li)) \
            + 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(
                L, axis1=-2, axis2=-1))))

    g_got = jax.grad(lambda B: loss(linalg.chol_with_inv, B))(B0)
    g_ref = jax.grad(lambda B: loss(ref_pair, B))(B0)
    np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_ref),
                               rtol=1e-9, atol=1e-11)
    del jsl


def test_gauss_kl_with_prior_inverse_matches_solve_path():
    """gauss_kl(Lp=..., Lp_inv=...) (inverse-matmul form) must match the
    TRSM form in value and gradients."""
    M, R = 10, 3
    q_mu = jnp.asarray(RNG.randn(M, R))
    q_sqrt = jnp.asarray(np.tril(RNG.randn(R, M, M)) + 2 * np.eye(M))
    K = jnp.asarray(_random_spd(M))

    def kl(q_mu, q_sqrt, K, with_inv):
        Lp, Lp_inv = linalg.chol_with_inv(K)
        if with_inv:
            return linalg.gauss_kl(q_mu, q_sqrt, Lp=Lp, Lp_inv=Lp_inv)
        return linalg.gauss_kl(q_mu, q_sqrt, Lp=Lp)

    v_inv = kl(q_mu, q_sqrt, K, True)
    v_sol = kl(q_mu, q_sqrt, K, False)
    np.testing.assert_allclose(float(v_inv), float(v_sol), rtol=1e-11)
    g_inv = jax.grad(lambda *a: kl(*a, True), argnums=(0, 1, 2))(
        q_mu, q_sqrt, K)
    g_sol = jax.grad(lambda *a: kl(*a, False), argnums=(0, 1, 2))(
        q_mu, q_sqrt, K)
    for gi, gs in zip(g_inv, g_sol):
        np.testing.assert_allclose(np.asarray(gi), np.asarray(gs),
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("white", [False, True])
def test_conditional_with_factor_inverse_matches_solve_path(white):
    """multi_output_conditional(Lm_inv=...) must reproduce the TRSM path
    (values and gradients) — the training path runs the inverse form."""
    from deepcgp_tpu.ops.conditional import multi_output_conditional
    P, N, M, R = 4, 5, 9, 3
    Kmn = jnp.asarray(RNG.randn(P, N, M))
    Kmm = jnp.asarray(_random_spd(M))
    Knn = jnp.asarray(np.abs(RNG.randn(P, N)) + 1.0)
    f = jnp.asarray(RNG.randn(M, R))
    q_sqrt = jnp.asarray(np.tril(RNG.randn(R, M, M)) + 2 * np.eye(M))

    def run(Kmn, Kmm, f, q_sqrt, use_inv):
        Lm, Lm_inv = linalg.chol_with_inv(Kmm)
        mean, var = multi_output_conditional(
            Kmn, None, Knn, f, q_sqrt=q_sqrt, white=white, Lm=Lm,
            Lm_inv=Lm_inv if use_inv else None, layout='pnm')
        return mean, var

    m_i, v_i = run(Kmn, Kmm, f, q_sqrt, True)
    m_s, v_s = run(Kmn, Kmm, f, q_sqrt, False)
    np.testing.assert_allclose(np.asarray(m_i), np.asarray(m_s),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(v_i), np.asarray(v_s),
                               rtol=1e-9, atol=1e-11)

    def loss(Kmn, Kmm, f, q_sqrt, use_inv):
        mean, var = run(Kmn, Kmm, f, q_sqrt, use_inv)
        return jnp.sum(jnp.sin(mean)) + jnp.sum(jnp.log(var))

    g_i = jax.grad(lambda *a: loss(*a, True), argnums=(0, 1, 2, 3))(
        Kmn, Kmm, f, q_sqrt)
    g_s = jax.grad(lambda *a: loss(*a, False), argnums=(0, 1, 2, 3))(
        Kmn, Kmm, f, q_sqrt)
    for gi, gs in zip(g_i, g_s):
        np.testing.assert_allclose(np.asarray(gi), np.asarray(gs),
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_extract_patches_matches_oracle(stride):
    images = RNG.randn(3, 12, 10, 2)
    want = oracle.extract_patches(images, 5, stride)
    got = np.asarray(extract_patches(jnp.asarray(images), 5, stride))
    np.testing.assert_allclose(got, want, atol=1e-12)
    got_conv = np.asarray(extract_patches_conv(jnp.asarray(images), 5, stride))
    np.testing.assert_allclose(got_conv, want, atol=1e-12)


@pytest.mark.parametrize("stride", [1, 2])
def test_extract_patches_native_perm_relation(stride):
    """patches_native[..., i] == patches_tf[..., native_perm[i]] — the
    contract every [L]-indexed parameter permutation relies on
    (DEEPCGP_PATCH_ORDER=native A/B path)."""
    from deepcgp_tpu.ops.patches import extract_patches_native, native_perm
    images = RNG.randn(3, 12, 10, 2)
    tf_order = np.asarray(extract_patches(jnp.asarray(images), 5, stride))
    nat = np.asarray(extract_patches_native(jnp.asarray(images), 5, stride))
    perm = native_perm(5, 2)
    assert sorted(perm.tolist()) == list(range(50))
    np.testing.assert_allclose(nat, tf_order[..., perm], atol=1e-12)


def test_native_patch_order_elbo_and_grads_match(monkeypatch):
    """DEEPCGP_PATCH_ORDER=native is numerically transparent: the ELBO and
    every parameter gradient of a 2-layer conv stack match the TF-order
    path to f64 reassociation noise (Z rides the column permutation)."""
    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='3,3',
                         strides='2,1', num_samples=2, batch_size=4)
    X = RNG.randn(16, 9, 9, 2)
    Y = RNG.randint(0, 3, size=(16, 1))
    monkeypatch.setenv('DEEPCGP_PATCH_ORDER', 'tf')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    Xd = jnp.asarray(X.reshape(16, -1))
    Yd = jnp.asarray(Y)
    key = jax.random.PRNGKey(3)

    def elbo_fn(m):
        return m.elbo(Xd[:4], Yd[:4], key)

    e_tf, g_tf = jax.value_and_grad(elbo_fn)(model)
    monkeypatch.setenv('DEEPCGP_PATCH_ORDER', 'native')
    e_nat, g_nat = jax.value_and_grad(elbo_fn)(model)
    np.testing.assert_allclose(float(e_nat), float(e_tf), rtol=1e-12)
    scale = max(float(jnp.max(jnp.abs(g))) for g in
                jax.tree_util.tree_leaves(g_tf))
    for a, b in zip(jax.tree_util.tree_leaves(g_tf),
                    jax.tree_util.tree_leaves(g_nat)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9 * scale)


def test_full_view_geometry_matches_reference():
    # 28x28, filter 5, stride 1 -> 576 patches (SURVEY.md §5.7).
    v = FullView(input_size=(28, 28), filter_size=5, feature_maps=1)
    assert v.patch_count == 576
    assert v.patch_length == 25
    assert (v.out_image_height, v.out_image_width) == (24, 24)
    v2 = FullView(input_size=(32, 32), filter_size=5, feature_maps=3, stride=3)
    assert v2.patch_count == 100
    assert v2.patch_length == 75
    X = RNG.randn(2, 28, 28, 1)
    pnl = np.asarray(v.extract_patches_PNL(jnp.asarray(X)))
    assert pnl.shape == (576, 2, 25)
    np.testing.assert_allclose(pnl[0, 0], X[0, :5, :5, 0].ravel())


def test_random_partial_view():
    # Mirrors reference tests/test_views.py:15-29.
    v = RandomPartialView(input_size=(28, 28), filter_size=3, feature_maps=1,
                          patch_count=5, seed=0)
    assert len(v.patch_indices) == 5
    X = RNG.randn(10, 28, 28, 1)
    p = np.asarray(v.extract_patches_PNL(jnp.asarray(X)))
    assert p.shape == (5, 10, 9)
    # Value equality against direct slicing.
    full_w = 28 - 3 + 1
    flat = v.patch_indices[0]
    y, x = flat // full_w, flat % full_w
    np.testing.assert_allclose(p[0, 0], X[0, y:y + 3, x:x + 3, 0].ravel())
    # Deterministic under the same seed.
    v_again = RandomPartialView(input_size=(28, 28), filter_size=3,
                                feature_maps=1, patch_count=5, seed=0)
    assert v_again.patch_indices == v.patch_indices


def test_self_gram_uses_exact_precision():
    """Self-grams (X2=None) must request Precision.HIGHEST — a
    reduced-precision f32 matmul (TF32 on the H100) carries enough error to
    un-PSD an ill-conditioned Kuu past the 1e-3 jitter (NaN Cholesky at init,
    observed in examples/regression.py).  Cross-covariances keep the fast
    default."""
    import jax
    import jax.numpy as jnp
    from deepcgp_tpu.ops.distances import square_distance

    X = jnp.zeros((4, 3))
    self_jaxpr = str(jax.make_jaxpr(lambda x: square_distance(x))(X))
    cross_jaxpr = str(jax.make_jaxpr(
        lambda x: square_distance(x, x + 1.0))(X))
    assert 'HIGHEST' in self_jaxpr
    assert 'HIGHEST' not in cross_jaxpr



@pytest.mark.parametrize("batched", [False, True])
def test_gram_syrk_vjp(batched):
    """linalg.gram_syrk's collapsed backward (C + C^T) X must equal plain
    autodiff of matmul(X, X^T) — which emits two operand cotangents — for
    an arbitrary non-symmetric cotangent, including batched grams."""
    shape = (4, 6, 5) if batched else (6, 5)
    X = jnp.asarray(RNG.randn(*shape))
    C = jnp.asarray(RNG.randn(*shape[:-1], shape[-2]))

    plain = lambda x: jnp.einsum(   # noqa: E731
        '...nd,...md->...nm', x, x)
    np.testing.assert_allclose(np.asarray(linalg.gram_syrk(X)),
                               np.asarray(plain(X)), rtol=1e-12)
    _, vjp_got = jax.vjp(linalg.gram_syrk, X)
    _, vjp_ref = jax.vjp(plain, X)
    np.testing.assert_allclose(np.asarray(vjp_got(C)[0]),
                               np.asarray(vjp_ref(C)[0]),
                               rtol=1e-11, atol=1e-13)


def test_syrk_sum_vjp():
    """linalg.syrk_sum's collapsed backward (C + C^T) Lq must equal plain
    autodiff of the einsum it wraps (which emits two separate operand
    cotangents) for an arbitrary — non-symmetric — cotangent."""
    R, M = 3, 7
    Lq = jnp.asarray(np.tril(RNG.randn(R, M, M)))
    C = jnp.asarray(RNG.randn(M, M))  # deliberately not symmetric

    plain = lambda x: jnp.einsum('rmk,rnk->mn', x, x)  # noqa: E731
    np.testing.assert_allclose(np.asarray(linalg.syrk_sum(Lq)),
                               np.asarray(plain(Lq)), rtol=1e-12)
    _, vjp_got = jax.vjp(linalg.syrk_sum, Lq)
    _, vjp_ref = jax.vjp(plain, Lq)
    np.testing.assert_allclose(np.asarray(vjp_got(C)[0]),
                               np.asarray(vjp_ref(C)[0]),
                               rtol=1e-11, atol=1e-13)
