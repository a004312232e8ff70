"""Training-layer tests: optimizers, natural gradients, builder, checkpoint,
and an end-to-end smoke train (SURVEY.md §7 stages 5-7)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deepcgp_tpu.models.base_kernels import RBF
from deepcgp_tpu.models.builder import BuilderFlags, build_model, parse_ints
from deepcgp_tpu.models.dgp import DGP
from deepcgp_tpu.models.layers import SVGPLayer
from deepcgp_tpu.models.likelihoods import Gaussian
from deepcgp_tpu.training import optim, trainer
from deepcgp_tpu.training.trainer import TrainConfig
from deepcgp_tpu.utils import checkpoint as ckpt

RNG = np.random.RandomState(3)


# -------------------------------------------------------------------- optim
def test_learning_rate_staircase():
    sched = optim.learning_rate_schedule(0.01, 100)
    assert float(sched(0)) == pytest.approx(0.01)
    assert float(sched(99)) == pytest.approx(0.01)
    assert float(sched(100)) == pytest.approx(0.001)
    assert float(sched(250)) == pytest.approx(1e-4)
    assert float(sched(300)) == pytest.approx(1e-5)


def test_learning_rate_continuous_matches_committed_artifacts():
    """--lr-decay-continuous reproduces the lr column of the reference's
    committed result runs exactly (results/N60000_M64/log.csv: continuous
    0.01*0.1^(t/25000), NOT the staircase of its current source)."""
    sched = optim.learning_rate_schedule(0.01, 25000, staircase=False)
    assert float(sched(5000)) == pytest.approx(0.0063095735, rel=1e-5)
    assert float(sched(10000)) == pytest.approx(0.0039810715, rel=1e-5)
    assert float(sched(75000)) == pytest.approx(1.0e-05, rel=1e-5)


def test_gamma_schedule_matches_reference_formula():
    # min((step/100 * 1e-3 + gamma0) * 0.2^steps_back, 1)
    g = optim.gamma_schedule(jnp.asarray(200), jnp.asarray(0.0), 0.001)
    assert float(g) == pytest.approx(0.003)
    g = optim.gamma_schedule(jnp.asarray(200), jnp.asarray(2.0), 0.001)
    assert float(g) == pytest.approx(0.003 * 0.04)
    g = optim.gamma_schedule(jnp.asarray(10 ** 9), jnp.asarray(0.0), 0.001)
    assert float(g) == 1.0


@pytest.mark.slow
def test_natgrad_f32_multistep_stability():
    """f32 NatGrad stability canary: several hundred steps on a learnable
    problem must keep the ELBO bounded and finite.  A numerically weaker
    (algebraically equivalent) natgrad implementation — the inverse-matmul
    chol pullback tried in round 2 — passed every unit test but diverged
    the 15k-step soak to a degenerate state; this is the cheap CI
    stand-in for that soak."""
    rng = np.random.RandomState(0)
    flags = BuilderFlags(M='16,16', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=2, batch_size=16)
    K = 4
    protos = rng.randn(K, 12, 12, 1).astype(np.float32)
    y = rng.randint(0, K, size=(256, 1))
    X = protos[y[:, 0]] + 0.3 * rng.randn(256, 12, 12, 1).astype(np.float32)
    model = build_model(flags, X, y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='NatGrad', lr=0.01, lr_decay_steps=5000,
                         gamma=0.001, batch_size=16)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(256, -1))
    Yd = jnp.asarray(y)
    first = None
    for _ in range(4):
        state, elbos = trainer.run_chunk(state, config, Xd, Yd, 100)
        e = np.asarray(elbos)
        if first is None:
            first = e[0]
        assert np.isfinite(e[-1])
    # Improved and never exploded by orders of magnitude.
    assert e[-1] > first
    assert np.abs(e).max() < 100.0 * np.abs(first)


def test_onehot_gather_bitwise():
    """run_chunk's one-hot minibatch selection must be bitwise identical to
    jnp.take (one-hot rows are exact in every matmul precision; labels
    round-trip exactly through float)."""
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.randn(256, 33).astype(np.float32))
    Y = jnp.asarray(rng.randint(0, 10, size=(256, 1)))
    idx = jnp.asarray(rng.randint(0, 256, 16))
    oh = jax.nn.one_hot(idx, 256, dtype=X.dtype)
    got = jax.lax.dot_general(oh, X, (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jnp.take(X, idx, axis=0)))
    gotY = jax.lax.dot_general(oh, Y.astype(X.dtype),
                               (((1,), (0,)), ((), ())),
                               precision=jax.lax.Precision.HIGHEST
                               ).astype(Y.dtype)
    np.testing.assert_array_equal(np.asarray(gotY),
                                  np.asarray(jnp.take(Y, idx, axis=0)))


def test_expectation_vjp_matches_autodiff():
    """The hand-written chol-free pullback of eta -> (mu, chol(S)) must
    equal jax.vjp through the factorizing version (it exists purely to skip
    the batched Cholesky recomputation — optim.py:_expectation_vjp)."""
    rng = np.random.RandomState(0)
    R, M = 3, 6
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(M)
    W = np.linalg.cholesky(S)
    mu = rng.randn(R, M)
    eta1 = jnp.asarray(mu)
    eta2 = jnp.asarray(S + mu[:, :, None] * mu[:, None, :])
    dmu = jnp.asarray(rng.randn(R, M))
    dW = jnp.asarray(np.tril(rng.randn(R, M, M)))

    _, vjp_fn = jax.vjp(optim._expectation_to_meanvarsqrt, eta1, eta2)
    ref1, ref2 = vjp_fn((dmu, dW))
    got1, got2 = optim._expectation_vjp(jnp.asarray(mu), jnp.asarray(W),
                                        dmu, dW)
    np.testing.assert_allclose(np.asarray(got1), np.asarray(ref1),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(ref2),
                               rtol=1e-9, atol=1e-11)


def test_natgrad_matches_theta_roundtrip():
    """The fused natgrad update (mu - g W G^-1 W^T dmu, chol(W G^-1 W^T)
    with G = I + 2g sym(phi(W^T dW)) — optim.py:natgrad_update) must equal
    the explicit theta-space round trip it collapses
    (optim.py:natgrad_update_theta), across gamma magnitudes."""
    rng = np.random.RandomState(7)
    R, M = 3, 8
    A = rng.randn(R, M, M)
    S = A @ np.swapaxes(A, -1, -2) + 5.0 * np.eye(M)
    q_sqrt = jnp.asarray(np.linalg.cholesky(S))
    q_mu = jnp.asarray(rng.randn(M, R))
    dq_mu = jnp.asarray(rng.randn(M, R))
    dq_sqrt = jnp.asarray(rng.randn(R, M, M))
    for gamma in (1e-4, 1e-3, 1e-2):
        mu_f, W_f = optim.natgrad_update(q_mu, q_sqrt, dq_mu, dq_sqrt,
                                         jnp.asarray(gamma))
        mu_t, W_t = optim.natgrad_update_theta(q_mu, q_sqrt, dq_mu, dq_sqrt,
                                               jnp.asarray(gamma))
        assert np.isfinite(np.asarray(W_f)).all(), gamma
        np.testing.assert_allclose(np.asarray(mu_f), np.asarray(mu_t),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(W_f), np.asarray(W_t),
                                   rtol=1e-8, atol=1e-10)
    # When the step leaves the PD cone (huge gamma), BOTH forms must signal
    # it with non-finite output (same backoff trigger); the NaN layout
    # inside the failed factor is implementation-specific.
    mu_f, W_f = optim.natgrad_update(q_mu, q_sqrt, dq_mu, dq_sqrt,
                                     jnp.asarray(0.5))
    mu_t, W_t = optim.natgrad_update_theta(q_mu, q_sqrt, dq_mu, dq_sqrt,
                                           jnp.asarray(0.5))
    assert not np.isfinite(np.asarray(W_f)).all()
    assert not np.isfinite(np.asarray(W_t)).all()


def test_natural_to_meanvarsqrt_flip_identity():
    """The exchange-trick chol(P^-1) equals the naive
    chol(P) -> invert -> re-chol route (one factorization instead of two)."""
    rng = np.random.RandomState(1)
    R, M = 4, 9
    A = rng.randn(R, M, M)
    P = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(M)
    theta1 = jnp.asarray(rng.randn(R, M))
    theta2 = jnp.asarray(-0.5 * P)
    mu, W = optim._natural_to_meanvarsqrt(theta1, theta2)
    S = np.linalg.inv(P)
    np.testing.assert_allclose(np.asarray(W), np.linalg.cholesky(S),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(mu),
                               np.einsum('rmn,rn->rm', S,
                                         np.asarray(theta1)),
                               rtol=1e-8, atol=1e-10)
    # Lower-triangular with positive diagonal (a genuine Cholesky factor).
    assert np.allclose(np.asarray(W), np.tril(np.asarray(W)))
    assert (np.asarray(W).diagonal(axis1=-2, axis2=-1) > 0).all()


def test_natgrad_layer_stacking_matches_per_layer():
    """Same-(M, R) layers are updated in ONE stacked natgrad call; the
    result must equal per-layer updates exactly (the update is independent
    per GP column)."""

    class FakeLayer:
        def __init__(self, q_mu, q_sqrt):
            self.q_mu, self.q_sqrt = q_mu, q_sqrt

        def replace(self, q_mu, q_sqrt):
            return FakeLayer(q_mu, q_sqrt)

    rng = np.random.RandomState(2)
    M, R = 7, 3
    layers, grads = [], []
    for _ in range(2):
        A = rng.randn(R, M, M)
        W = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + 3 * np.eye(M))
        layers.append(FakeLayer(jnp.asarray(rng.randn(M, R)),
                                jnp.asarray(W)))
        grads.append(FakeLayer(jnp.asarray(0.01 * rng.randn(M, R)),
                               jnp.asarray(0.01 * np.tril(
                                   rng.randn(R, M, M)))))
    gamma = jnp.asarray(0.1)
    sb = jnp.asarray(0.0)

    stacked, _, ok = optim.natgrad_step_with_backoff(
        tuple(layers), tuple(grads), gamma, sb)
    assert bool(ok)
    for layer, g, got in zip(layers, grads, stacked):
        mu_ref, W_ref = optim.natgrad_update(layer.q_mu, layer.q_sqrt,
                                             g.q_mu, g.q_sqrt, gamma)
        np.testing.assert_allclose(np.asarray(got.q_mu), np.asarray(mu_ref),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(got.q_sqrt), np.asarray(W_ref),
                                   rtol=1e-9, atol=1e-11)


def _gaussian_svgp(N=20, M=8, D=3, R=2):
    X = RNG.randn(N, D)
    W = RNG.randn(D, R)
    Y = X @ W + 0.1 * RNG.randn(N, R)
    base = RBF.create(variance=1.0, lengthscales=1.2, dtype=jnp.float64)
    Z = RNG.randn(M, D)
    layer = SVGPLayer.create(base, Z, num_outputs=R, dtype=jnp.float64)
    lik = Gaussian.create(variance=0.1, dtype=jnp.float64)
    model = DGP(layers=(layer,), likelihood=lik, num_data=N, num_samples=1)
    return model, jnp.asarray(X), jnp.asarray(Y)


def test_natgrad_one_step_reaches_conjugate_optimum():
    """With a Gaussian likelihood and a single layer the ELBO is available in
    closed form in (q_mu, q_sqrt); a gamma=1 natural-gradient step lands on
    the optimal q, so a second step is a fixed point (Salimbeni et al. 2018
    — the property gpflow's NatGradOptimizer is built on)."""
    model, X, Y = _gaussian_svgp()
    key = jax.random.PRNGKey(0)

    def do_step(m):
        grads = jax.grad(lambda mm: -mm.elbo(X, Y, key))(m)
        layers, _, ok = optim.natgrad_step_with_backoff(
            m.layers, grads.layers, jnp.asarray(1.0, jnp.float64),
            jnp.asarray(0.0))
        assert bool(ok)
        return m.replace(layers=layers)

    m1 = do_step(model)
    elbo1 = float(m1.elbo(X, Y, key))
    elbo0 = float(model.elbo(X, Y, key))
    assert elbo1 > elbo0
    m2 = do_step(m1)
    np.testing.assert_allclose(np.asarray(m2.layers[0].q_mu),
                               np.asarray(m1.layers[0].q_mu), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jnp.tril(m2.layers[0].q_sqrt)),
                               np.asarray(jnp.tril(m1.layers[0].q_sqrt)),
                               atol=1e-6)


def test_natgrad_backoff_on_failure():
    model, X, Y = _gaussian_svgp()
    grads = jax.grad(lambda m: -m.elbo(X, Y, jax.random.PRNGKey(0)))(model)
    # A step that destroys positive-definiteness surfaces as NaNs from the
    # Cholesky (JAX raises no exception); emulate with non-finite grads.
    bad_grads = jax.tree_util.tree_map(lambda g: g * jnp.nan, grads)
    layers, steps_back, ok = optim.natgrad_step_with_backoff(
        model.layers, bad_grads.layers, jnp.asarray(1.0, jnp.float64),
        jnp.asarray(0.0))
    assert not bool(ok)
    assert float(steps_back) == 1.0
    # Old parameters kept.
    np.testing.assert_allclose(np.asarray(layers[0].q_mu),
                               np.asarray(model.layers[0].q_mu))
    assert np.all(np.isfinite(np.asarray(layers[0].q_sqrt)))


# ------------------------------------------------------------------ builder
def _small_flags(**kw):
    defaults = dict(M='6,8', feature_maps='2', filter_sizes='5,3',
                    strides='2,1', base_kernel='rbf', last_kernel='conv',
                    white=False, identity_mean=False, num_samples=2,
                    batch_size=8)
    defaults.update(kw)
    return BuilderFlags(**defaults)


def _small_data(n=40):
    X = RNG.randn(n, 12, 12, 1).astype(np.float64)
    Y = RNG.randint(0, 10, size=(n, 1))
    return X, Y


def test_builder_shapes_and_geometry():
    X, Y = _small_data()
    model = build_model(_small_flags(), X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    assert len(model.layers) == 2
    l1 = model.layers[0]
    # 12x12, f5, s2 -> 4x4 = 16 patches.
    assert l1.view.patch_count == 16
    assert l1.Z.shape == (6, 25)
    assert l1.q_mu.shape == (6, 2)
    assert l1.q_sqrt.shape == (2, 6, 6)
    # Fresh q_sqrt scaled 1e-5 (conv_gp/models.py:136-138).
    assert float(jnp.max(jnp.abs(l1.q_sqrt))) < 1e-3
    l2 = model.layers[1]
    assert l2.q_mu.shape == (8, 10)
    # Last layer sees the identity-conv-propagated 4x4x2 image; filter 3
    # stride 1 -> 2x2 = 4 patches of length 18.
    assert l2.kernel.view.patch_count == 4
    assert l2.Z.shape == (8, 18)


def test_builder_last_kernels():
    X, Y = _small_data()
    for last in ('conv', 'add', 'rbf'):
        flags = _small_flags(M='6,8', filter_sizes='5,3', strides='2,1',
                             last_kernel=last)
        model = build_model(flags, X, Y, jax.random.PRNGKey(1),
                            dtype=jnp.float64)
        Xf = jnp.asarray(X.reshape(40, -1)[:6])
        Yb = jnp.asarray(Y[:6])
        elbo = float(model.elbo(Xf, Yb, jax.random.PRNGKey(2)))
        assert np.isfinite(elbo), last


def test_builder_identity_mean_and_acos():
    X, Y = _small_data()
    flags = _small_flags(identity_mean=True, base_kernel='acos',
                         filter_sizes='5,3', strides='2,1')
    model = build_model(flags, X, Y, jax.random.PRNGKey(1),
                        dtype=jnp.float64)
    Xf = jnp.asarray(X.reshape(40, -1)[:6])
    elbo = float(model.elbo(Xf, jnp.asarray(Y[:6]), jax.random.PRNGKey(2)))
    assert np.isfinite(elbo)


# -------------------------------------------------------------- trainable mask
def test_trainable_mask_freezes_filters_and_Z0():
    X, Y = _small_data()
    flags = _small_flags(identity_mean=True, filter_sizes='5,3',
                         strides='2,1')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    mask = optim.trainable_mask(model, exclude_variational=False)
    assert mask.layers[0].mean_function.conv_filter is False
    assert mask.layers[0].Z0 is False
    assert mask.layers[0].q_mu is True
    mask_ng = optim.trainable_mask(model, exclude_variational=True)
    assert mask_ng.layers[0].q_mu is False
    assert mask_ng.layers[0].q_sqrt is False
    assert mask_ng.layers[0].Z is True


# ------------------------------------------------------------- checkpointing
def test_checkpoint_roundtrip_and_depth_remap(tmp_path):
    X, Y = _small_data()
    flags = _small_flags(filter_sizes='5,3', strides='2,1')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    path = os.path.join(tmp_path, 'model.npy')
    ckpt.save_model(path, model, global_step=123)

    step, layer_params = ckpt.load_layer_parameters(path, 2)
    assert step == 123
    model2 = build_model(flags, X, Y, jax.random.PRNGKey(9),
                         loaded_parameters=layer_params, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(model2.layers[0].q_sqrt),
                               np.asarray(jnp.tril(model.layers[0].q_sqrt)))
    np.testing.assert_allclose(np.asarray(model2.layers[1].Z),
                               np.asarray(model.layers[1].Z))
    np.testing.assert_allclose(
        float(model2.layers[0].base_kernel.variance),
        float(model.layers[0].base_kernel.variance), rtol=1e-6)

    # Depth remap: grow a 3-layer model from the 2-layer checkpoint
    # (conv_gp/models.py:231-238) - saved last layer lands in slot 2.
    step, lp3 = ckpt.load_layer_parameters(path, 3)
    assert 2 in lp3 and 0 in lp3 and 1 not in lp3
    np.testing.assert_allclose(lp3[2]['Z'], np.asarray(model.layers[1].Z))


def test_reference_rbf_last_layer_checkpoint_import(tmp_path):
    """A genuine reference snapshot of a plain-RBF last layer stores its
    hyperparameters under UN-prefixed pathnames ('kern/variance',
    'kern/lengthscales' — gpflow pathname of a bare RBF), and the reference
    reads them back as bare keys (`conv_gp/models.py:162-164`).  Importing
    such a snapshot must preserve them — and our own rbf-last-layer save
    must round-trip through the same format."""
    X, Y = _small_data()
    flags = _small_flags(last_kernel='rbf')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)

    # (a) Synthetic reference-layout snapshot: bare 'kern/*' pathnames.
    D = model.layers[1].Z.shape[1]
    ls = np.linspace(1.0, 3.0, D)
    ref_snapshot = {
        'DGP/layers/0/q_mu': np.asarray(model.layers[0].q_mu),
        'DGP/layers/0/q_sqrt': np.asarray(jnp.tril(model.layers[0].q_sqrt)),
        'DGP/layers/0/feature/Z': np.asarray(model.layers[0].Z),
        'DGP/layers/0/kern/base_kernel/variance': np.float64(2.5),
        'DGP/layers/0/kern/base_kernel/lengthscales': np.float64(1.5),
        'DGP/layers/1/q_mu': np.asarray(model.layers[1].q_mu),
        'DGP/layers/1/q_sqrt': np.asarray(jnp.tril(model.layers[1].q_sqrt)),
        'DGP/layers/1/feature/Z': np.asarray(model.layers[1].Z),
        'DGP/layers/1/kern/variance': np.float64(7.0),
        'DGP/layers/1/kern/lengthscales': ls,
        'global_step': 42,
    }
    step, layer_params = ckpt.parse_layer_parameters(ref_snapshot, 2)
    assert step == 42
    assert 'variance' in layer_params[1] and 'lengthscales' in layer_params[1]
    model2 = build_model(flags, X, Y, jax.random.PRNGKey(7),
                         loaded_parameters=layer_params, dtype=jnp.float64)
    np.testing.assert_allclose(float(model2.layers[1].kernel.variance), 7.0,
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(model2.layers[1].kernel.lengthscales),
                               ls, rtol=1e-10)
    np.testing.assert_allclose(
        float(model2.layers[0].base_kernel.variance), 2.5, rtol=1e-10)

    # (b) Our own save writes the same un-prefixed layout for a bare-RBF
    # last layer and round-trips.
    path = os.path.join(tmp_path, 'rbf_last.npy')
    ckpt.save_model(path, model2, global_step=43)
    raw = ckpt.load_raw(path)
    assert 'DGP/layers/1/kern/variance' in raw
    assert 'DGP/layers/1/kern/base_kernel/variance' not in raw
    step, lp = ckpt.load_layer_parameters(path, 2)
    model3 = build_model(flags, X, Y, jax.random.PRNGKey(8),
                         loaded_parameters=lp, dtype=jnp.float64)
    np.testing.assert_allclose(float(model3.layers[1].kernel.variance), 7.0,
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(model3.layers[1].kernel.lengthscales),
                               ls, rtol=1e-10)


# ------------------------------------------------------- end-to-end training
def test_run_chunk_improves_elbo_adam():
    X, Y = _small_data(64)
    flags = _small_flags(filter_sizes='5,3', strides='2,1')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=1000,
                         gamma=0.001, batch_size=16)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(64, -1))
    Yd = jnp.asarray(Y)
    state, elbos1 = trainer.run_chunk(state, config, Xd, Yd, 30)
    state, elbos2 = trainer.run_chunk(state, config, Xd, Yd, 30)
    assert int(state.step) == 60
    assert float(jnp.mean(elbos2)) > float(jnp.mean(elbos1))
    # Frozen Z0 unchanged by training.
    np.testing.assert_allclose(np.asarray(state.model.layers[0].Z0),
                               np.asarray(model.layers[0].Z0))


def test_run_chunk_natgrad_smoke():
    X, Y = _small_data(48)
    flags = _small_flags(filter_sizes='5,3', strides='2,1')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    config = TrainConfig(optimizer='NatGrad', lr=0.01, lr_decay_steps=1000,
                         gamma=0.001, batch_size=12)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(48, -1))
    state, elbos = trainer.run_chunk(state, config, Xd, jnp.asarray(Y), 10)
    assert np.all(np.isfinite(np.asarray(elbos)))
    # Variational params moved (natgrad) and kernel params moved (adam).
    assert float(jnp.max(jnp.abs(state.model.layers[0].q_mu))) > 0
    assert float(jnp.abs(state.model.layers[0].base_kernel.raw_variance -
                         model.layers[0].base_kernel.raw_variance)) > 0


def test_accuracy_eval_runs():
    X, Y = _small_data(40)
    flags = _small_flags(filter_sizes='5,3', strides='2,1')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    acc = trainer.accuracy(model, X.reshape(40, -1), Y,
                           jax.random.PRNGKey(0), batch_size=16)
    assert 0.0 <= acc <= 1.0


def test_nan_step_is_skipped_not_committed():
    """A numerically failed step (NaN loss/grads) must not poison parameters
    or Adam moments (the in-scan analog of the reference's cholesky-failure
    retry, `conv_gp/experiment.py:38-49`)."""
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8, 8, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    flags = BuilderFlags(M='4,4', feature_maps='2', filter_sizes='3,3',
                         strides='2,1', num_samples=2, batch_size=8)
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=100,
                         gamma=0.001, batch_size=8)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(32, -1))
    Yd = jnp.asarray(Y)

    # One good step so Adam moments are nonzero.
    state, _ = trainer.run_chunk(state, config, Xd, Yd, 1)
    before = jax.tree_util.tree_map(np.asarray, state.model)

    # Poisoned batch -> NaN loss; the step must be skipped.
    x_bad = Xd[:8].at[0, 0].set(jnp.nan)
    step = jax.jit(lambda s, x, y: trainer.train_step(s, config, x, y))
    state2, elbo_bad = step(state, x_bad, Yd[:8])
    assert not np.isfinite(float(elbo_bad))  # failure is visible in the trace
    after = jax.tree_util.tree_map(np.asarray, state2.model)
    for b, a in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(b, a)
    assert int(state2.step) == int(state.step) + 1

    # And training continues cleanly from the preserved state.
    state3, elbos = trainer.run_chunk(state2, config, Xd, Yd, 3)
    assert np.isfinite(np.asarray(elbos)).all()


def _natgrad_probe_setup():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8, 8, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    flags = BuilderFlags(M='4,4', feature_maps='2', filter_sizes='3,3',
                         strides='2,1', num_samples=2, batch_size=8)
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='NatGrad', lr=0.01, lr_decay_steps=100,
                         gamma=0.001, batch_size=8)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    return state, config, jnp.asarray(X.reshape(32, -1)), jnp.asarray(Y)


@pytest.mark.slow
def test_natgrad_bad_batch_not_committed_and_bumps_gamma():
    """A non-finite loss must not let either half of the NatGrad step commit,
    and must bump steps_back (reference catch/step_back_gamma/retry
    semantics, `conv_gp/experiment.py:38-49`)."""
    state, config, Xd, Yd = _natgrad_probe_setup()
    before = jax.tree_util.tree_map(np.asarray, state.model)
    sb_before = float(state.steps_back)

    x_bad = Xd[:8].at[0, 0].set(jnp.nan)  # poisons natgrad AND adam halves
    step = jax.jit(lambda s, x, y: trainer.train_step(s, config, x, y))
    state2, elbo_bad = step(state, x_bad, Yd[:8])
    assert not np.isfinite(float(elbo_bad))
    after = jax.tree_util.tree_map(np.asarray, state2.model)
    for b, a in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(b, a)
    assert float(state2.steps_back) >= sb_before + 1.0
    # Recovery: clean batches train on with the reduced gamma.
    state3, elbos = trainer.run_chunk(state2, config, Xd, Yd, 3)
    assert np.isfinite(np.asarray(elbos)).all()


def test_natgrad_deferred_rollback_restores_last_verified_params():
    """Single-backward NatGrad verifies each commit with the NEXT step's
    loss evaluation: a committed state whose ELBO turns out non-finite must
    be rolled back to ``prev_model`` (the last verified parameters) so
    training can continue — without this, a finite-but-poisonous proposal
    would deadlock every subsequent step at NaN."""
    state, config, Xd, Yd = _natgrad_probe_setup()
    state, _ = trainer.run_chunk(state, config, Xd, Yd, 2)
    good = jax.tree_util.tree_map(np.asarray, state.model)

    # Emulate a finite NatGrad proposal that breaks the ELBO: poison the
    # committed model with finite-but-absurd variational params.
    bad_layers = list(state.model.layers)
    bad_layers[0] = bad_layers[0].replace(
        q_sqrt=jnp.full_like(bad_layers[0].q_sqrt, 1e30))
    state_bad = state.replace(
        model=state.model.replace(layers=tuple(bad_layers)))
    assert not np.isfinite(float(state_bad.model.elbo(
        Xd[:8], Yd[:8], jax.random.PRNGKey(3))))

    # prev_model still holds verified params; the next CLEAN step detects
    # the NaN loss and rolls back to them.
    step = jax.jit(lambda s, x, y: trainer.train_step(s, config, x, y))
    state2, elbo_bad = step(state_bad, Xd[:8], Yd[:8])
    assert not np.isfinite(float(elbo_bad))
    prev = jax.tree_util.tree_map(np.asarray, state.prev_model)
    after = jax.tree_util.tree_map(np.asarray, state2.model)
    for p, a in zip(jax.tree_util.tree_leaves(prev),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(p, a)
    # And the recovered state trains on cleanly.
    state3, elbos = trainer.run_chunk(state2, config, Xd, Yd, 3)
    assert np.isfinite(np.asarray(elbos)).all()
    # Sanity: the rollback target was itself a trained state, not init.
    assert any(np.any(g != 0) for g in
               [np.asarray(state.prev_model.layers[0].q_mu)])
    del good


def test_adam_storage_matches_optax():
    """scale_by_adam_storage(None) must reproduce optax.scale_by_adam
    exactly (same recurrences + bias correction); the bf16-storage variant
    must track it to within bf16 rounding of the moments."""
    import optax

    from deepcgp_tpu.training import optim

    params = {'a': jnp.asarray(np.random.RandomState(0).randn(4, 3),
                               jnp.float32)}
    ref = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    mine = optim.scale_by_adam_storage(None, b1=0.9, b2=0.999, eps=1e-8)
    bf16 = optim.scale_by_adam_storage(jnp.bfloat16)

    s_ref, s_mine, s_bf = (ref.init(params), mine.init(params),
                           bf16.init(params))
    rng = np.random.RandomState(1)
    for step in range(5):
        g = {'a': jnp.asarray(rng.randn(4, 3), jnp.float32)}
        u_ref, s_ref = ref.update(g, s_ref)
        u_mine, s_mine = mine.update(g, s_mine)
        u_bf, s_bf = bf16.update(g, s_bf)
        # optax computes its bias correction in a (weak-typed) higher
        # precision under x64; the f32-native form differs by ~7e-6.
        np.testing.assert_allclose(np.asarray(u_mine['a']),
                                   np.asarray(u_ref['a']), rtol=2e-5)
        np.testing.assert_allclose(np.asarray(u_bf['a']),
                                   np.asarray(u_ref['a']), rtol=0.05,
                                   atol=0.02)
    assert s_bf.mu['a'].dtype == jnp.bfloat16
    assert s_bf.nu['a'].dtype == jnp.bfloat16


def test_adam_bf16_moments_trains(monkeypatch):
    """run_chunk with DEEPCGP_ADAM_MOMENT_DTYPE=bfloat16 stays finite and
    the ELBO moves (f32 model; the real gate is the soak on the card)."""
    monkeypatch.setenv('DEEPCGP_ADAM_MOMENT_DTYPE', 'bfloat16')
    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig

    rng = np.random.RandomState(0)
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=2, batch_size=8)
    X = rng.randn(32, 12, 12, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=1000,
                         gamma=0.001, batch_size=8)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    leaf = jax.tree_util.tree_leaves(state.opt_state)[1]
    assert leaf.dtype == jnp.bfloat16
    Xd = jnp.asarray(X.reshape(32, -1))
    Yd = jnp.asarray(Y)
    state, e1 = trainer.run_chunk(state, config, Xd, Yd, 8)
    state, e2 = trainer.run_chunk(state, config, Xd, Yd, 8)
    assert np.isfinite(np.asarray(e1)).all()
    assert np.isfinite(np.asarray(e2)).all()
    assert float(np.mean(np.asarray(e2))) > float(np.mean(np.asarray(e1)))


def test_sr_to_bf16_exact_and_unbiased():
    """optim._sr_to_bf16: values already representable in bf16 round to
    themselves under every salt; values strictly between bf16 neighbours
    land on one of the two neighbours with probabilities that average to
    the input (unbiasedness is what fixes the RTN v-freeze — PARITY.md
    round-4)."""
    from deepcgp_tpu.training import optim

    # Exactly-representable values (incl. negatives and zero).
    x = jnp.asarray([0.0, 1.0, -2.5, 3.140625, -0.00390625], jnp.float32)
    for salt in (0, 1, 123456789):
        y = optim._sr_to_bf16(x, jnp.uint32(salt))
        np.testing.assert_array_equal(np.asarray(y, np.float32),
                                      np.asarray(x))

    # Strictly-interior values: mean over many salts ~ x, outputs are
    # always one of the two bf16 neighbours.
    rng = np.random.RandomState(0)
    base = rng.randn(256).astype(np.float32)
    lo = np.asarray(jnp.asarray(base, jnp.bfloat16), np.float32)
    # Construct x strictly between lo and the next bf16 up.
    hi = np.asarray(jnp.nextafter(jnp.asarray(lo, jnp.bfloat16),
                                  jnp.asarray(np.inf, jnp.bfloat16)),
                    np.float32)
    frac = 0.25 + 0.5 * rng.rand(256).astype(np.float32)
    x = (lo + frac * (hi - lo)).astype(np.float32)
    acc = np.zeros_like(x, dtype=np.float64)
    trials = 400
    for salt in range(trials):
        y = np.asarray(optim._sr_to_bf16(jnp.asarray(x),
                                         jnp.uint32(salt * 2654435761
                                                    & 0xFFFFFFFF)),
                       np.float32)
        assert np.all((y == lo) | (y == hi)), "SR must hit a neighbour"
        acc += y
    mean = (acc / trials).astype(np.float32)
    # Unbiased to ~sqrt(p(1-p)/trials) of the ulp gap.
    err = np.abs(mean - x) / (hi - lo)
    assert float(err.mean()) < 0.05, float(err.mean())
    assert float(err.max()) < 0.2, float(err.max())


def test_adam_storage_sr_tracks_optax():
    """The stochastic-rounding bf16 variant tracks optax within bf16
    rounding (same envelope as RTN) and stores bf16 moments."""
    import optax

    from deepcgp_tpu.training import optim

    params = {'a': jnp.asarray(np.random.RandomState(0).randn(4, 3),
                               jnp.float32)}
    ref = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    sr = optim.scale_by_adam_storage(jnp.bfloat16, stochastic_round=True)
    s_ref, s_sr = ref.init(params), sr.init(params)
    rng = np.random.RandomState(1)
    for step in range(5):
        g = {'a': jnp.asarray(rng.randn(4, 3), jnp.float32)}
        u_ref, s_ref = ref.update(g, s_ref)
        u_sr, s_sr = sr.update(g, s_sr)
        np.testing.assert_allclose(np.asarray(u_sr['a']),
                                   np.asarray(u_ref['a']), rtol=0.05,
                                   atol=0.02)
    assert s_sr.mu['a'].dtype == jnp.bfloat16
    assert s_sr.nu['a'].dtype == jnp.bfloat16


def test_adam_bf16_sr_moments_trains(monkeypatch):
    """run_chunk with DEEPCGP_ADAM_MOMENT_DTYPE=bfloat16_sr stays finite
    and the ELBO improves (f32 model; the numerics gate is the soak on the
    card)."""
    monkeypatch.setenv('DEEPCGP_ADAM_MOMENT_DTYPE', 'bfloat16_sr')
    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig

    rng = np.random.RandomState(0)
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=2, batch_size=8)
    X = rng.randn(32, 12, 12, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=1000,
                         gamma=0.001, batch_size=8)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    leaf = jax.tree_util.tree_leaves(state.opt_state)[1]
    assert leaf.dtype == jnp.bfloat16
    Xd = jnp.asarray(X.reshape(32, -1))
    Yd = jnp.asarray(Y)
    state, e1 = trainer.run_chunk(state, config, Xd, Yd, 8)
    state, e2 = trainer.run_chunk(state, config, Xd, Yd, 8)
    assert np.isfinite(np.asarray(e1)).all()
    assert np.isfinite(np.asarray(e2)).all()
    assert float(np.mean(np.asarray(e2))) > float(np.mean(np.asarray(e1)))


def test_adam_storage_auto_per_leaf():
    """'auto' picks bf16-SR storage only for >=2^22-element f32 leaves;
    small leaves keep exact f32 moments (bit-identical to optax)."""
    import optax

    from deepcgp_tpu.training import optim

    big = jnp.zeros((1 << 22,), jnp.float32)
    small = jnp.asarray(np.random.RandomState(0).randn(4, 3), jnp.float32)
    params = {'big': big, 'small': small}
    auto = optim.scale_by_adam_storage('auto')
    ref = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    s_auto, s_ref = auto.init(params), ref.init(params)
    assert s_auto.mu['big'].dtype == jnp.bfloat16
    assert s_auto.nu['big'].dtype == jnp.bfloat16
    assert s_auto.mu['small'].dtype == jnp.float32
    rng = np.random.RandomState(1)
    for _ in range(3):
        g = {'big': jnp.zeros((1 << 22,), jnp.float32),
             'small': jnp.asarray(rng.randn(4, 3), jnp.float32)}
        u_auto, s_auto = auto.update(g, s_auto)
        u_ref, s_ref = ref.update(g, s_ref)
        # Small leaves: EXACT f32 arithmetic ==> tracks optax to fp noise.
        np.testing.assert_allclose(np.asarray(u_auto['small']),
                                   np.asarray(u_ref['small']), rtol=2e-5)
        np.testing.assert_array_equal(np.asarray(s_auto.mu['small']),
                                      np.asarray(s_ref.mu['small']))


def test_resume_across_moment_dtype_change(tmp_path, monkeypatch):
    """A checkpoint written with f32 moments must restore under the 'auto'
    default (and vice versa): the moment STORAGE dtype is an
    implementation detail, not part of the training state contract."""
    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig
    from deepcgp_tpu.utils import checkpoint as ckpt

    rng = np.random.RandomState(0)
    flags = BuilderFlags(M='8', feature_maps='', filter_sizes='3',
                         strides='1', num_samples=2, batch_size=8,
                         last_kernel='rbf')
    X = rng.randn(32, 8, 8, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=1000,
                         gamma=0.001, batch_size=8)

    monkeypatch.setenv('DEEPCGP_ADAM_MOMENT_DTYPE', 'float32')
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(32, -1))
    state, _ = trainer.run_chunk(state, config, Xd, jnp.asarray(Y), 2)
    ckpt.save_train_state(str(tmp_path), state)

    # Same-dtype restore under 'auto' (tiny leaves stay f32): exact.
    monkeypatch.setenv('DEEPCGP_ADAM_MOMENT_DTYPE', 'auto')
    template = trainer.init_state(model, config, jax.random.PRNGKey(1))
    restored = ckpt.restore_train_state(str(tmp_path), template)
    lt, lr_ = (jax.tree_util.tree_leaves(template.opt_state),
               jax.tree_util.tree_leaves(restored.opt_state))
    for t, r in zip(lt, lr_):
        assert t.dtype == r.dtype, (t.dtype, r.dtype)

    # GENUINE dtype-mismatch migration: the f32-moment snapshot
    # restores into a bf16-storage template (cast on restore), so
    # m1024-scale checkpoints from before the SR-bf16 default still resume.
    monkeypatch.setenv('DEEPCGP_ADAM_MOMENT_DTYPE', 'bfloat16_sr')
    tpl_bf16 = trainer.init_state(model, config, jax.random.PRNGKey(1))
    moments_bf16 = [l for l in jax.tree_util.tree_leaves(tpl_bf16.opt_state)
                    if l.dtype == jnp.bfloat16]
    assert moments_bf16, "bf16 template must actually hold bf16 moments"
    r_bf16 = ckpt.restore_train_state(str(tmp_path), tpl_bf16)
    for t, r, orig in zip(jax.tree_util.tree_leaves(tpl_bf16.opt_state),
                          jax.tree_util.tree_leaves(r_bf16.opt_state),
                          jax.tree_util.tree_leaves(state.opt_state)):
        assert r.dtype == t.dtype, (r.dtype, t.dtype)
        if orig.dtype != r.dtype:  # one-time RTN cast of the f32 value
            np.testing.assert_allclose(np.asarray(r, np.float32),
                                       np.asarray(orig, np.float32),
                                       rtol=8e-3, atol=1e-8)
    assert int(r_bf16.step) == 2

    # Reverse direction: a bf16-moment snapshot resumes into f32 (exact).
    st_bf16, _ = trainer.run_chunk(r_bf16, config, Xd, jnp.asarray(Y), 2)
    ckpt.save_train_state(str(tmp_path), st_bf16)
    monkeypatch.setenv('DEEPCGP_ADAM_MOMENT_DTYPE', 'float32')
    tpl_f32 = trainer.init_state(model, config, jax.random.PRNGKey(1))
    r_f32 = ckpt.restore_train_state(str(tmp_path), tpl_f32)
    for t, r, orig in zip(jax.tree_util.tree_leaves(tpl_f32.opt_state),
                          jax.tree_util.tree_leaves(r_f32.opt_state),
                          jax.tree_util.tree_leaves(st_bf16.opt_state)):
        assert r.dtype == t.dtype
        np.testing.assert_array_equal(np.asarray(r, np.float32),
                                      np.asarray(orig, np.float32))
