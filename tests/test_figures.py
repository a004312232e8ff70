"""Figure rendering smoke tests (utils/figures.py; the reference notebooks'
output artifacts)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip('matplotlib')

from deepcgp_tpu.models.builder import BuilderFlags, build_model
from deepcgp_tpu.utils import figures


@pytest.fixture(scope='module')
def tiny_model_and_data():
    rng = np.random.RandomState(0)
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=2, batch_size=8)
    X = rng.randn(32, 12, 12, 1)
    Y = rng.randint(0, 10, size=(32, 1))
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    return model, X, Y


def test_render_run_figures_writes_all_pngs(tmp_path, tiny_model_and_data):
    model, X, Y = tiny_model_and_data
    paths = figures.render_run_figures(
        str(tmp_path), model, X, X.reshape(32, -1), Y,
        jax.random.PRNGKey(1), noise_levels=(0.0, 0.5),
        max_eval_points=16)
    assert paths
    names = {os.path.basename(p) for p in paths}
    # Both layers of this config have patch views -> two grids, one
    # embedding, one robustness curve.
    assert 'inducing_grid_layer0.png' in names
    assert 'inducing_grid_layer1.png' in names
    assert 'patch_embedding_layer0.png' in names
    assert 'noise_robustness.png' in names
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_render_noise_robustness_standalone(tmp_path):
    p = figures.render_noise_robustness(
        {0.0: 0.98, 0.5: 0.9, 1.0: 0.6}, str(tmp_path / 'nr.png'))
    assert os.path.getsize(p) > 1000
