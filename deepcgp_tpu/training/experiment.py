"""Experiment driver (rebuild of `conv_gp/experiment.py`).

Template-method lifecycle: load data -> build model -> optimizer -> loggers
(`conv_gp/experiment.py:14-20`); ``train_step()`` runs one ``test_every``-
iteration epoch (a single jitted on-device scan), then logs and snapshots
parameters (`conv_gp/experiment.py:28-31,56-64`).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from deepcgp_tpu.models.builder import build_model
from deepcgp_tpu.training import trainer
from deepcgp_tpu.training.arguments import train_steps
from deepcgp_tpu.training.trainer import TrainConfig
from deepcgp_tpu.utils import checkpoint as ckpt
from deepcgp_tpu.utils.log import (AccuracyLogger, GlobalStepLogger,
                                   LearningRateLogger, Log, TrainELBOLogger)


def eval_key(seed: int, global_step: int) -> jax.Array:
    """PRNG key for a test-set evaluation at ``global_step``: deterministic
    given (seed, step), different across steps."""
    return jax.random.fold_in(jax.random.PRNGKey(seed + 2), global_step)


class Experiment:
    def __init__(self, flags):
        self.flags = flags
        self.last_mean_elbo = float('nan')
        # Multi-host SPMD must be initialised before the first device use
        # (it changes what jax.devices() returns on every process).
        if getattr(flags, 'distributed', False) or \
                os.environ.get('JAX_COORDINATOR_ADDRESS'):
            from deepcgp_tpu.parallel import multihost
            multihost.initialize_distributed()
        self._load_data()
        self._setup_model()
        self._setup_optimizer()
        self._setup_logger()

    # -- subclass hooks -------------------------------------------------------
    def _load_data(self):
        raise NotImplementedError

    # -- lifecycle ------------------------------------------------------------
    def conclude(self):
        self.log.close()
        if self.tensorboard_log is not None:
            self.tensorboard_log.close()

    def train_step(self):
        self._optimize()
        self._log_step()
        self._save_model_parameters()

    def run(self):
        # A resumed run (--full-state-ckpt or --load-model) executes only
        # the REMAINDER of the flags' schedule, not the full count again.
        done = int(self.state.step) // self.flags.test_every
        try:
            for _ in range(max(0, train_steps(self.flags) - done)):
                self.train_step()
        finally:
            self.conclude()

    # -- internals -------------------------------------------------------------
    def _optimize(self):
        if self.mesh is not None:
            self.state, elbos = self._sharded_chunk(
                self.state, self.X_train_dev, self.Y_train_dev,
                self.flags.test_every)
        else:
            self.state, elbos = trainer.run_chunk(
                self.state, self.config, self.X_train_dev, self.Y_train_dev,
                self.flags.test_every)
        self.last_mean_elbo = float(jnp.mean(elbos)) / self.flags.batch_size

    def _log_step(self):
        entry = self.log.write_entry(self)
        if self.tensorboard_log is not None:
            self.tensorboard_log.write_entry(self)
        print(entry, flush=True)

    def _model_path(self, model_name=None):
        if model_name is None:
            model_name = self.flags.name
        return os.path.join(self.flags.log_dir, model_name + '.npy')

    @property
    def _is_writer(self) -> bool:
        """Single-writer rule: with a shared --log-dir, exactly one process
        (index 0) owns every artifact — .npy snapshot, CSV, options.toml,
        preprocessing.npz, TensorBoard, orbax state.
        All processes still COMPUTE eval entries (SPMD collectives)."""
        return jax.process_index() == 0

    def _save_model_parameters(self):
        if self._is_writer:
            ckpt.save_model(self._model_path(), self.state.model,
                            self.global_step)
        if getattr(self.flags, 'full_state_ckpt', False):
            # EVERY process calls the orbax save: with jax.distributed
            # initialized it is a collective (internal sync barriers); a
            # process-0-only call deadlocks the cluster.  Orbax itself
            # enforces the single-writer rule for the file contents.
            ckpt.save_train_state(self._state_dir(), self.state)

    def _state_dir(self) -> str:
        return os.path.join(self.flags.log_dir, self.flags.name + '_state')

    def _setup_model(self):
        key = jax.random.PRNGKey(self.flags.seed)
        loaded, initial_step = None, 0
        if self.flags.load_model is not None:
            from deepcgp_tpu.models.builder import parse_ints
            num_layers = len(parse_ints(str(self.flags.M)))
            initial_step, loaded = ckpt.load_layer_parameters(
                self._model_path(self.flags.load_model), num_layers)
        self.model = build_model(self.flags, self.X_train, self.Y_train,
                                 key, loaded_parameters=loaded)
        self.initial_step = initial_step

    def _setup_optimizer(self):
        if self.flags.optimizer not in ('Adam', 'NatGrad', 'SGD'):
            raise ValueError("Not a supported optimizer. Try Adam or NatGrad.")
        self.config = TrainConfig(
            optimizer=self.flags.optimizer, lr=self.flags.lr,
            lr_decay_steps=self.flags.lr_decay_steps,
            gamma=self.flags.gamma, batch_size=self.flags.batch_size,
            lr_staircase=not getattr(self.flags, 'lr_decay_continuous',
                                     False))
        key = jax.random.PRNGKey(self.flags.seed + 1)
        self.state = trainer.init_state(self.model, self.config, key,
                                        global_step=self.initial_step)
        # Multi-chip: '--mesh data=4,model=2' runs the training chunk as a
        # pjit'd SPMD program over the device mesh (§2.10 of SURVEY.md is
        # explicit that the reference has nothing like this).
        self.mesh = None
        self._sharded_chunk = None
        self._sharded_eval = None
        if getattr(self.flags, 'mesh', ''):
            from deepcgp_tpu.parallel import mesh as mesh_lib
            from deepcgp_tpu.parallel.train import (make_sharded_accuracy_fn,
                                                    make_sharded_train_fns)
            self.mesh = mesh_lib.make_mesh(self.flags.mesh)
            _, self._sharded_chunk = make_sharded_train_fns(self.mesh,
                                                            self.config)
            self._sharded_eval = make_sharded_accuracy_fn(self.mesh,
                                                          batch_size=32,
                                                          num_samples=5)
        # Preemption resume: restore the full state (incl. optimizer
        # moments, unlike the reference's .npy path) when present.
        if getattr(self.flags, 'full_state_ckpt', False) and \
                ckpt.latest_train_state_step(self._state_dir()) is not None:
            self.state = ckpt.restore_train_state(self._state_dir(),
                                                  self.state)
            print(f"resumed full train state at step {int(self.state.step)}",
                  flush=True)
        # Training data resident on device, flattened.  Under a mesh the
        # resident set is built through the multihost input path: each
        # process ships only its contiguous row shard host->device, and the
        # shards assemble into ONE global jax.Array row-sharded over 'data'
        # (at process_count=1 the "shard" is the whole set, so the same code
        # runs single-host — parallel/multihost.py).  Model construction
        # above intentionally used the FULL arrays: k-means inducing-point
        # init must be identical on every process or the SPMD programs
        # diverge; only the device-resident copies are sharded.
        X_flat = self.X_train.reshape(self.X_train.shape[0], -1)
        if self.mesh is not None:
            from deepcgp_tpu.parallel import multihost
            self.X_train_dev, self.Y_train_dev = multihost.host_local_to_global(
                self.mesh,
                multihost.process_shard(X_flat),
                multihost.process_shard(self.Y_train))
        else:
            self.X_train_dev = jnp.asarray(X_flat)
            self.Y_train_dev = jnp.asarray(self.Y_train)
        # --natgrad-warm-steps: a fresh NatGrad run (step 0 — resumes and
        # --load-model restarts skip this) first trains the model with Adam
        # for a short phase, then reinitializes the NatGrad state from the
        # warmed model.
        warm = int(getattr(self.flags, 'natgrad_warm_steps', 0) or 0)
        if (self.flags.optimizer == 'NatGrad' and warm > 0
                and int(self.state.step) == 0):
            self._natgrad_warm_start(warm)

    def _natgrad_warm_start(self, warm_steps: int):
        """Adam warm start for NatGrad (`--natgrad-warm-steps`).

        From the builder's cold 1e-5-scaled q_sqrt init
        (`conv_gp/experiment.py:115-129` semantics), NatGrad spends
        thousands of steps at chance-level accuracy under a small gamma0
        and overshoots into Cholesky-failure backoff under a large one;
        a short Adam phase places the variational state in the basin and
        NatGrad then matches or beats Adam from the first eval (measured
        on UCI digits — PARITY.md 'NatGrad convergence on digits').
        An extension alongside the reference's gamma step-back
        machinery (`conv_gp/experiment.py:74-80`)."""
        cfg = TrainConfig(optimizer='Adam', lr=self.flags.lr,
                          lr_decay_steps=self.flags.lr_decay_steps,
                          gamma=self.flags.gamma,
                          batch_size=self.flags.batch_size,
                          lr_staircase=self.config.lr_staircase)
        key = jax.random.PRNGKey(self.flags.seed + 1)
        st = trainer.init_state(self.model, cfg, key)
        if self.mesh is not None:
            from deepcgp_tpu.parallel.train import make_sharded_train_fns
            _, chunk = make_sharded_train_fns(self.mesh, cfg)
            st, _ = chunk(st, self.X_train_dev, self.Y_train_dev,
                          warm_steps)
        else:
            st, _ = trainer.run_chunk(st, cfg, self.X_train_dev,
                                      self.Y_train_dev, warm_steps)
        self.model = st.model
        self.state = trainer.init_state(
            self.model, self.config, jax.random.PRNGKey(self.flags.seed + 1),
            global_step=self.initial_step)
        print(f"natgrad warm start: {warm_steps} Adam steps", flush=True)

    def _setup_logger(self):
        from deepcgp_tpu.utils.profiling import StepsPerSecLogger
        loggers = [GlobalStepLogger(), LearningRateLogger(),
                   AccuracyLogger(), TrainELBOLogger(), StepsPerSecLogger()]
        self.log = Log(self.flags.log_dir, self.flags.name, loggers,
                       write=self._is_writer)
        self.log.write_flags(self.flags)
        # Persist preprocessing statistics for serving (Predictor applies
        # them to raw inputs; the reference only predicted in-process).
        prep = getattr(self.flags, 'preprocessing', None)
        if prep is not None and self._is_writer:
            import numpy as np
            np.savez(os.path.join(self.log.log_dir, 'preprocessing.npz'),
                     **prep)
        self.tensorboard_log = None
        if self._is_writer and not getattr(self.flags, 'no_tensorboard',
                                           False):
            try:
                from deepcgp_tpu.utils.tensorboard import make_default_log
                self.tensorboard_log = make_default_log(self)
            except Exception as e:  # TB is optional observability
                print(f"tensorboard logging disabled: {e}")

    # -- logger accessors -------------------------------------------------------
    @property
    def global_step(self) -> int:
        return int(self.state.step)

    @property
    def learning_rate(self) -> float:
        from deepcgp_tpu.training.optim import learning_rate_schedule
        return float(learning_rate_schedule(
            self.flags.lr, self.flags.lr_decay_steps,
            staircase=self.config.lr_staircase)(self.state.step))

    def test_accuracy(self) -> float:
        X = self.X_test.reshape(self.X_test.shape[0], -1)
        # Fresh-but-reproducible MC noise per evaluation: the reference
        # draws new samples each eval (`conv_gp/utils/log.py:62`); deriving
        # the key from the global step decorrelates the accuracy column's
        # sampling noise across epochs without losing determinism.
        key = eval_key(self.flags.seed, self.global_step)
        if self._sharded_eval is not None:
            # Eval rides the mesh too: test-batch rows over 'data', patch
            # axis over 'model' (same PRNG path as the single-device eval).
            # Inputs go through the multihost path (identity single-host)
            # and only the replicated accuracy SCALAR leaves the mesh, so
            # this works unchanged at process_count > 1.  The test set is
            # static — assemble the global arrays once and reuse them
            # every test_every evaluation.
            if getattr(self, '_test_dev', None) is None:
                import numpy as np
                from deepcgp_tpu.parallel import multihost
                # Pad (sentinel labels) to a multiple of both the process
                # count and the 'data' axis, so every test row survives the
                # even split over processes and devices; accuracy divides by
                # the TRUE count below.
                import math
                multiple = math.lcm(jax.process_count(),
                                    dict(self.mesh.shape).get('data', 1))
                Xp, Yp = multihost.pad_rows(np.asarray(X),
                                            np.asarray(self.Y_test),
                                            multiple)
                self._test_dev = multihost.host_local_to_global(
                    self.mesh,
                    multihost.process_shard(Xp),
                    multihost.process_shard(Yp))
            Xg, Yg = self._test_dev
            count = self._sharded_eval(self.state.model, Xg, Yg, key)
            return float(count) / self.Y_test.size
        return float(trainer.accuracy(
            self.state.model, X, self.Y_test, key,
            batch_size=32, num_samples=5))
