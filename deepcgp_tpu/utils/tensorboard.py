"""TensorBoard observability (rebuild of `conv_gp/utils/tensorboard.py`,
using tensorboardX instead of TF summaries).

Tasks mirror the reference:
* ``LogLikelihoodLogger`` — train ELBO estimate on <=5000 training points,
  evaluated in batches (`conv_gp/utils/tensorboard.py:15-42`);
* ``LayerOutputLogger``  — sampled layer-0 outputs / means / variances
  rendered with matplotlib into image summaries (`:44-145`);
* ``ModelParameterLogger`` — scalar + histogram summaries of every model
  parameter (`:148-162`);
* ``PatchCovarianceLogger`` — Kuf heatmaps for a random image (`:164-195`).
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _elbo_jit(m, x, y, k):
    return m.elbo(x, y, k)


def _step_index(step: int, n: int) -> int:
    """Deterministic pseudo-random row index derived from the step (Knuth
    multiplicative hash) — replaces the unseeded ``np.random`` draws that
    were the last nondeterminism in the library."""
    return (int(step) * 2654435761) % max(int(n), 1)


class LogLikelihoodLogger:
    title = 'train_log_likelihood'

    def __init__(self, batch_size: int = 64, compute_on: int = 5000):
        self.batch_size = batch_size
        self.compute_on = compute_on

    def __call__(self, writer, experiment, step):
        model = experiment.state.model
        # Host-local rows, NOT the device-resident training set: under a
        # mesh X_train_dev is a 'data'-sharded global array whose rows are
        # not all addressable from this process;
        # the host copy is always complete and the slices here are tiny.
        X = experiment.X_train.reshape(experiment.X_train.shape[0], -1)
        Y = experiment.Y_train
        n = min(self.compute_on, X.shape[0])
        batches = math.ceil(n / self.batch_size)
        total = 0.0
        # Step-derived key: fresh MC noise each eval, reproducible per step.
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        elbo_fn = _elbo_jit  # module-level: one trace per shape, not per call
        for i in range(batches):
            sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
            key, sub = jax.random.split(key)
            total += float(elbo_fn(model, jnp.asarray(X[sl]),
                                   jnp.asarray(Y[sl]), sub))
        writer.add_scalar(self.title, total / (batches * self.batch_size),
                          step)


class ModelParameterLogger:
    def __call__(self, writer, experiment, step):
        flat = jax.tree_util.tree_flatten_with_path(experiment.state.model)[0]
        for path, leaf in flat:
            name = 'model' + ''.join(str(p) for p in path)
            arr = np.asarray(leaf)
            if arr.size == 1:
                writer.add_scalar(name, float(arr.reshape(())), step)
            else:
                writer.add_histogram(name, arr.reshape(-1), step)


class LayerOutputLogger:
    """Renders one test image's layer-0 samples/mean/variance maps."""

    def __init__(self, num_samples: int = 4):
        self.num_samples = num_samples

    def __call__(self, writer, experiment, step):
        from deepcgp_tpu.models.layers import ConvLayer
        model = experiment.state.model
        layer = model.layers[0]
        if not isinstance(layer, ConvLayer):
            return
        X = experiment.X_test.reshape(experiment.X_test.shape[0], -1)
        idx = _step_index(step, X.shape[0])
        x = jnp.asarray(X[idx:idx + 1])
        cache = layer.precompute()
        mean, var = layer.conditional_mean_var(cache, x)
        key = jax.random.PRNGKey(step)
        z = jax.random.normal(key, (self.num_samples,) + mean.shape,
                              mean.dtype)
        samples = np.asarray(mean[None] + z * jnp.sqrt(var[None] + 1e-6))
        fm = layer.gp_count
        hw = layer.view.out_image_height, layer.view.out_image_width
        writer.add_image('conv_sample',
                         _grid_image(samples[:, 0], hw, fm), step)
        writer.add_image('conv_mean',
                         _grid_image(np.asarray(mean), hw, fm), step)
        writer.add_image('conv_var',
                         _grid_image(np.asarray(var), hw, fm), step)


class PatchCovarianceLogger:
    def __call__(self, writer, experiment, step):
        from deepcgp_tpu.models.layers import ConvLayer
        model = experiment.state.model
        layer = model.layers[0]
        if not isinstance(layer, ConvLayer):
            return
        X = experiment.X_train.reshape(experiment.X_train.shape[0], -1)
        idx = _step_index(step, X.shape[0])
        H, W = layer.view.input_size
        img = jnp.asarray(
            X[idx:idx + 1]).reshape(1, H, W, layer.view.feature_maps)
        patches = layer.view.extract_patches_PNL(jnp.asarray(img))
        Kuf = np.asarray(layer.conv_kernel.Kuf(layer.Z, patches))  # [P, M, 1]
        writer.add_image('Kuf_covariance',
                         _to_image(Kuf[:, :, 0]), step)


def _normalize(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo + 1e-12)


def _to_image(arr2d: np.ndarray) -> np.ndarray:
    return _normalize(arr2d)[None, :, :]  # CHW, 1 channel


def _grid_image(rows: np.ndarray, hw, feature_maps: int) -> np.ndarray:
    """rows: [S, P*fm] patch-major -> tiled [1, S*h, fm*w] image."""
    rows = np.atleast_2d(rows)
    S = rows.shape[0]
    h, w = hw
    imgs = rows.reshape(S, h, w, feature_maps)
    tiled = np.concatenate(
        [np.concatenate([_normalize(imgs[s, :, :, f]) for f in
                         range(feature_maps)], axis=1) for s in range(S)],
        axis=0)
    return tiled[None]


class TensorBoardLog:
    def __init__(self, tasks, tensorboard_dir: str, name: str):
        from tensorboardX import SummaryWriter
        os.makedirs(os.path.join(tensorboard_dir, name), exist_ok=True)
        self.writer = SummaryWriter(os.path.join(tensorboard_dir, name))
        self.tasks = tasks

    def write_entry(self, experiment):
        step = experiment.global_step
        for task in self.tasks:
            task(self.writer, experiment, step)

    def close(self):
        self.writer.close()


def make_default_log(experiment) -> TensorBoardLog:
    tasks = [LogLikelihoodLogger(), ModelParameterLogger(),
             LayerOutputLogger()]
    return TensorBoardLog(tasks,
                          getattr(experiment.flags, 'tensorboard_dir',
                                  '/tmp/deepcgp/tensorboard'),
                          experiment.flags.name)
