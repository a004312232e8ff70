"""Numerics diagnostics + profiling loggers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcgp_tpu.models.builder import BuilderFlags, build_model
from deepcgp_tpu.utils import diagnostics as diag
from deepcgp_tpu.utils.profiling import StepTimer


def _tiny_model():
    rng = np.random.RandomState(0)
    X = rng.randn(48, 8, 8, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(48, 1))
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='3,3',
                         strides='2,1', num_samples=2, batch_size=8)
    return build_model(flags, X, Y, jax.random.PRNGKey(0),
                       dtype=jnp.float32), X, Y


@pytest.mark.slow
def test_elbo_f32_f64_drift_small():
    model, X, Y = _tiny_model()
    out = diag.elbo_drift(model, X[:16].reshape(16, -1), Y[:16],
                          jax.random.PRNGKey(1))
    assert np.isfinite(out['elbo_f32']) and np.isfinite(out['elbo_f64'])
    # f32 vs f64 agreement is the acceptance gate for f32 compute
    # (SURVEY.md hard part b).
    assert out['rel_drift'] < 1e-4, out


def test_param_health_flags_nans():
    model, _, _ = _tiny_model()
    assert diag.param_health(model) == {}
    bad = model.replace(layers=(
        model.layers[0].replace(
            q_mu=model.layers[0].q_mu.at[0, 0].set(jnp.nan)),
        *model.layers[1:]))
    health = diag.param_health(bad)
    assert any('q_mu' in k for k in health) and sum(health.values()) == 1


def test_cholesky_health():
    model, _, _ = _tiny_model()
    out = diag.cholesky_health(model)
    assert [h['cholesky_ok'] for h in out] == [True, True]


def test_step_timer():
    t = StepTimer()
    assert np.isnan(t.update(0))
    sps = t.update(50)
    assert sps > 0
