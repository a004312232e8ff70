"""Inference / serving layer.

The reference's only prediction surface is the accuracy logger's batched
``model.predict_y`` calls inside training (`conv_gp/utils/log.py:50-68`).
For production serving this build provides a standalone ``Predictor``:

* loads a model from a reference-format ``.npy`` snapshot (+ the flags
  recorded in ``options.toml``) or wraps an in-memory model;
* serves class probabilities / labels / predictive log-densities with ONE
  compiled program per batch shape — requests are padded to a fixed batch
  so every call after the first is compile-free;
* deterministic: MC sampling keys derive from a fixed seed + request count.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def _load_options_toml(path: str) -> dict:
    with open(path, 'rb') as f:
        import tomllib
        return tomllib.load(f)


class Predictor:
    """Batched, pad-to-shape, jit-cached prediction server."""

    def __init__(self, model, *, batch_size: int = 32, num_samples: int = 5,
                 seed: int = 0, preprocessing: dict | None = None,
                 mesh=None):
        self.model = model
        self.batch_size = batch_size
        self.num_samples = num_samples
        # {'mean': [D], 'scale': [D]} applied to raw inputs when set
        # (loaded from the run's preprocessing.npz by from_run_dir).
        self.preprocessing = preprocessing
        # Optional jax.sharding.Mesh (or a 'data=4,model=2' spec string):
        # prediction programs are traced under it so request batches shard
        # over 'data' and the patch axis over 'model' — serving scales over
        # the same mesh as training (single-chip serving at 8 chips would
        # leave 7 idle).
        if isinstance(mesh, str) and mesh:
            from deepcgp_tpu.parallel import mesh as mesh_lib
            mesh = mesh_lib.make_mesh(mesh)
        self.mesh = mesh or None
        self._base_key = jax.random.PRNGKey(seed)
        self._calls = 0
        S = num_samples
        B = batch_size

        # Per-batch jitted program + ASYNC host loop (one device sync per
        # REQUEST, not per batch): JAX dispatch is asynchronous, so queueing
        # every batch before the single block_until_ready pipelines
        # host->device transfer with compute.  A lax.scan over batches (one
        # dispatch per request) scheduled its multi-hundred-MB live
        # intermediates far worse than the identical body as a direct jit
        # call; trust only end-to-end timing.
        def _probs(m, xb, key):
            with self._mesh_ctx():
                probs, _ = m.predict_y(xb, key, S)
                return jnp.mean(probs, axis=0)

        self._probs_fn = jax.jit(_probs)

    def _mesh_ctx(self):
        import contextlib
        if self.mesh is None:
            return contextlib.nullcontext()
        from deepcgp_tpu.parallel.sharding import mesh_context
        return mesh_context(self.mesh)

    def _to_device(self, xb: np.ndarray):
        if self.mesh is None:
            return jnp.asarray(xb)
        from deepcgp_tpu.parallel import mesh as mesh_lib
        return mesh_lib.shard_batch(self.mesh, jnp.asarray(xb))

    @classmethod
    def from_run_dir(cls, run_dir: str, X_init: np.ndarray,
                     Y_init: np.ndarray, **kw) -> "Predictor":
        """Rebuild the model from a training run directory: flags from
        ``<run>/options.toml``, parameters from ``<run>/../<name>.npy``.
        ``X_init/Y_init``: data with the training shapes (only shapes and
        init statistics are used — loaded params override everything)."""
        from deepcgp_tpu.models.builder import build_model
        from deepcgp_tpu.utils import checkpoint as ckpt
        opts = _load_options_toml(os.path.join(run_dir, 'options.toml'))
        name = opts['name']
        snap = os.path.join(os.path.dirname(run_dir.rstrip('/')),
                            name + '.npy')
        from deepcgp_tpu.models.builder import parse_ints
        num_layers = len(parse_ints(str(opts['M'])))
        _, loaded = ckpt.load_layer_parameters(snap, num_layers)
        import types
        flags = types.SimpleNamespace(**opts)
        model = build_model(flags, X_init, Y_init, jax.random.PRNGKey(0),
                            loaded_parameters=loaded)
        prep_path = os.path.join(run_dir, 'preprocessing.npz')
        if 'preprocessing' not in kw and os.path.exists(prep_path):
            with np.load(prep_path) as d:
                kw['preprocessing'] = {'mean': d['mean'], 'scale': d['scale']}
        return cls(model, **kw)

    def _key(self) -> jax.Array:
        self._calls += 1
        return jax.random.fold_in(self._base_key, self._calls)

    def _prepare(self, X: np.ndarray, raw: bool) -> np.ndarray:
        """Flatten, and standardize raw inputs with the training scaler."""
        X = np.asarray(X)
        flat = X.reshape(X.shape[0], -1)
        if raw:
            if self.preprocessing is None:
                raise ValueError(
                    "raw=True requires preprocessing statistics (train with "
                    "the Experiment CLI, which persists preprocessing.npz)")
            flat = ((flat - self.preprocessing['mean'])
                    / self.preprocessing['scale']).astype(np.float32)
        return flat

    def _batches(self, flat: np.ndarray):
        """Yield fixed-size batches as ON-DEVICE slices of one padded
        request array: the whole request rides host->device in a single
        transfer (per-batch H2D round-trips dominated the request time —
        every batch is 12.6 MB but each transfer pays the full dispatch
        latency), and the per-batch slices are asynchronous device ops."""
        N = flat.shape[0]
        B = self.batch_size
        pad = (-N) % B
        if pad:
            flat = np.concatenate(
                [flat, np.zeros((pad,) + flat.shape[1:], flat.dtype)])
        Xd = self._to_device(flat)
        for start in range(0, N, B):
            yield start, min(B, N - start), Xd[start:start + B]

    def predict_proba(self, X: np.ndarray, raw: bool = False) -> np.ndarray:
        """[N, D or H, W, C] -> [N, K] mean class probabilities.  All
        batches are dispatched asynchronously and synced ONCE per request
        (see __init__ notes).

        ``raw=True`` standardizes with the persisted training statistics —
        pass the images exactly as they come off disk."""
        flat = self._prepare(X, raw)
        N = flat.shape[0]
        pending = []
        for start, n, xb in self._batches(flat):
            pending.append((start, n, self._probs_fn(
                self.model, xb, self._key())))
        jax.block_until_ready([p for _, _, p in pending])
        out = np.empty((N, self.model.likelihood.num_classes), np.float32)
        for start, n, probs in pending:
            out[start:start + n] = np.asarray(probs)[:n]
        return out

    def predict(self, X: np.ndarray, raw: bool = False) -> np.ndarray:
        """[N, ...] -> [N] argmax class labels."""
        return self.predict_proba(X, raw=raw).argmax(axis=1)

    def log_density(self, X: np.ndarray, Y: np.ndarray,
                    raw: bool = False) -> np.ndarray:
        """Per-point predictive log p(y | x), [N] — padded/batched like
        predict_proba so arbitrary request sizes reuse one compiled shape."""
        flat = self._prepare(X, raw)
        Y = np.asarray(Y).reshape(-1, 1)
        N = flat.shape[0]
        if Y.shape[0] != N:
            raise ValueError(f"X has {N} rows but Y has {Y.shape[0]} labels")
        if not hasattr(self, '_dens_fn'):
            S = self.num_samples

            def _dens(m, xb, yb, key):
                with self._mesh_ctx():
                    return m.predict_density(xb, yb, key, S)

            self._dens_fn = jax.jit(_dens)
        pending = []
        for start, n, xb in self._batches(flat):
            yb = np.zeros((xb.shape[0], 1), Y.dtype)
            yb[:n] = Y[start:start + n]
            pending.append((start, n, self._dens_fn(
                self.model, xb, jnp.asarray(yb), self._key())))
        jax.block_until_ready([d for _, _, d in pending])
        out = np.empty((N,), np.float32)
        for start, n, dens in pending:
            out[start:start + n] = np.asarray(dens)[:n, 0]
        return out
