"""Multi-device training step.

Builds a jitted train step whose minibatch is sharded over the mesh 'data'
axis (pure-SPMD data parallelism: the gradient psum is inserted by the XLA
partitioner) while the in-layer constraints from
deepcgp_tpu.parallel.sharding shard the patch axis over 'model'.

A fresh ``jax.jit`` wrapper is created *inside* the mesh context because the
sharding constraints are baked in at trace time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deepcgp_tpu.parallel import mesh as mesh_lib
from deepcgp_tpu.parallel.sharding import mesh_context
from deepcgp_tpu.training import trainer


def make_sharded_train_fns(mesh, config):
    """Returns (train_step_fn, run_chunk_fn) traced under ``mesh``.

    ``train_step_fn(state, xb, yb)``: one optimizer step on a batch whose
    leading axis is sharded over 'data'.
    ``run_chunk_fn(state, X, Y, num_steps)``: the scan variant with the full
    training set resident (replicated) on the mesh.
    """

    def _step(state, xb, yb):
        with mesh_context(mesh):
            return trainer.train_step(state, config, xb, yb)

    def _chunk(state, X, Y, num_steps):
        with mesh_context(mesh):
            return trainer.run_chunk_impl(state, config, X, Y, num_steps)

    # The returned TrainState is pinned FULLY REPLICATED: without the pin
    # GSPMD may leave some state leaf sharded over the mesh, and then a
    # multi-process writer cannot np.asarray it for checkpointing (a global
    # array spanning non-addressable devices raises — and the process-0
    # crash deadlocks every other process's next collective).
    from jax.sharding import NamedSharding, PartitionSpec
    rep = NamedSharding(mesh, PartitionSpec())
    step_jit = jax.jit(_step,
                       in_shardings=(None, mesh_lib.batch_sharding(mesh),
                                     mesh_lib.batch_sharding(mesh)),
                       out_shardings=(rep, rep))
    chunk_jit = jax.jit(_chunk, static_argnums=(3,),
                        out_shardings=(rep, rep))
    return step_jit, chunk_jit


def make_sharded_eval_fn(mesh, batch_size: int = 32, num_samples: int = 5):
    """Jitted whole-set class-probability eval traced under ``mesh``: the
    scanned per-step batch is sharded over 'data' and the in-layer
    constraints shard the patch axis over 'model' — the eval counterpart of
    :func:`make_sharded_train_fns` (single-chip eval at 8 chips would leave
    7 idle).

    Returns ``eval_fn(model, X, key) -> probs [N, K]``.
    """

    def _eval(model, X, key):
        with mesh_context(mesh):
            return _sharded_probs(mesh, model, X, key, batch_size,
                                  num_samples)

    return jax.jit(_eval, static_argnums=())


def _sharded_probs(mesh, model, X, key, batch_size, num_samples):
    """Shared traced body of the sharded eval/accuracy programs (callers
    hold the mesh_context)."""
    return trainer.predict_probs_impl(model, X, key, batch_size, num_samples)


def make_sharded_accuracy_fn(mesh, batch_size: int = 32,
                             num_samples: int = 5):
    """Jitted whole-set test ACCURACY under ``mesh``: like
    :func:`make_sharded_eval_fn` but reduces to the replicated scalar
    inside the program, so it works multi-process (per-host probability
    shards never need host assembly — only the scalar leaves the mesh).

    Returns ``acc_fn(model, X, Y, key) -> correct-prediction COUNT`` (an
    on-device replicated integer scalar); X/Y should be global arrays
    (multihost.host_local_to_global under multi-host); divide by the
    global Y.size host-side.
    """

    def _acc(model, X, Y, key):
        with mesh_context(mesh):
            probs = _sharded_probs(mesh, model, X, key, batch_size,
                                   num_samples)
            return trainer.correct_count_from_probs(probs, Y)

    return jax.jit(_acc)


def sharded_vs_replicated_elbos(mesh, model, config, X, Y, seed: int = 1):
    """Two optimizer steps from one initial state, once with the batch
    sharded over ``mesh`` (:func:`make_sharded_train_fns`) and once jitted
    on a single device.  Step 1 checks the forward ELBO under the mesh;
    step 2 checks the committed update (gradient psum + optimizer) fed back
    through the sharded program.  Returns ``[(sharded, replicated)]`` ELBO
    pairs, one per step.  A wrong-but-finite sharding (a dropped psum, a
    mis-sharded constraint) shows up as disagreement; the sharded program
    reorders reductions, so agreement is to tolerance, not bitwise."""
    step_fn, _ = make_sharded_train_fns(mesh, config)
    xs, ys = mesh_lib.shard_batch(mesh, X), mesh_lib.shard_batch(mesh, Y)
    state = trainer.init_state(model, config, jax.random.PRNGKey(seed))
    state, e1 = step_fn(state, xs, ys)
    _, e2 = step_fn(state, xs, ys)

    step = jax.jit(lambda s, x, y: trainer.train_step(s, config, x, y))
    ref = trainer.init_state(model, config, jax.random.PRNGKey(seed))
    ref, r1 = step(ref, X, Y)
    _, r2 = step(ref, X, Y)
    return [(float(e1), float(r1)), (float(e2), float(r2))]


def dryrun_multichip(n_devices: int, *, model_axis: int | None = None,
                     dtype=jnp.float32,
                     optimizers: tuple = ('Adam', 'NatGrad')) -> None:
    """Compile + execute ONE full sharded training step on tiny shapes over
    an ``n_devices``-device mesh (dp over batch x sp over the patch axis x
    the in-layer 'model'-axis constraints) for EVERY optimizer in
    ``optimizers`` — NatGrad's triangular solves / Choleskys compile under
    the mesh too, not just Adam — then one sharded
    whole-set eval.  Every sharded step is ASSERTED against the same step
    replicated on a single device (rtol 1e-6 f64 / 1e-4 f32), so the dry
    run catches wrong-but-finite sharding regressions, not just NaNs.
    Entry point of ``__graft_entry__.dryrun_multichip``; also exercised by
    tests on the 8-virtual-device CPU backend, including a poisoned-step
    fault injection."""
    import numpy as np

    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    from deepcgp_tpu.training.trainer import TrainConfig

    # The dry run is defined over N *virtual CPU* devices: request them
    # through jax config as well as XLA_FLAGS (harmless no-op when a
    # backend already exists with enough devices, e.g. under the test
    # conftest).
    if len(getattr(jax._src.xla_bridge, '_backends', {}) or {}) == 0:
        for key, val in (('jax_platforms', 'cpu'),
                         ('jax_num_cpu_devices', int(n_devices))):
            try:
                jax.config.update(key, val)
            except Exception:
                pass
    assert len(jax.devices()) >= n_devices, (
        f"dryrun_multichip needs {n_devices} devices, found "
        f"{len(jax.devices())} — run with JAX_PLATFORMS=cpu before any "
        "other jax use")

    if model_axis is None:
        model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // model_axis
    mesh = mesh_lib.make_mesh({'data': n_data, 'model': model_axis})

    rng = np.random.RandomState(0)
    # Tiny 2-layer conv GP: 12x12 images, 16-patch hidden layer.
    flags = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=2, batch_size=2 * n_data)
    X = rng.randn(64, 12, 12, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(64, 1))
    model = build_model(flags, X, Y, jax.random.PRNGKey(0), dtype=dtype)

    xh = jnp.asarray(X[:flags.batch_size].reshape(flags.batch_size, -1),
                     dtype=dtype)
    yh = jnp.asarray(Y[:flags.batch_size])
    rtol = 1e-6 if dtype == jnp.float64 else 1e-4

    def _check(tag, pairs):
        for i, (got, want) in enumerate(pairs, 1):
            assert np.isfinite(got), \
                f"multichip dryrun ({tag}) step{i} non-finite ELBO: {got}"
            assert abs(got - want) <= rtol * max(abs(want), 1.0), (
                f"multichip dryrun ({tag}) step{i} ELBO diverges from the "
                f"replicated reference: sharded {got!r} vs {want!r}")

    elbo_by_opt = {}
    for opt in optimizers:
        config = TrainConfig(optimizer=opt, lr=0.01, lr_decay_steps=1000,
                             gamma=0.001, batch_size=flags.batch_size)
        pairs = sharded_vs_replicated_elbos(mesh, model, config, xh, yh)
        _check(opt, pairs)
        elbo_by_opt[opt] = pairs[0][0]
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))

    # Sharded whole-set eval: batch rows over 'data', patches over 'model'.
    eval_fn = make_sharded_eval_fn(mesh, batch_size=flags.batch_size,
                                   num_samples=2)
    Xe = mesh_lib.shard_batch(
        mesh, jnp.asarray(X[:16].reshape(16, -1), dtype=dtype))
    probs = eval_fn(state.model, Xe, jax.random.PRNGKey(2))
    assert probs.shape == (16, 10)
    assert np.isfinite(np.asarray(probs)).all()

    # M=1024-geometry config (single ConvKernel SVGP layer, scaled M):
    # pins the SURVEY §2.10 "M-sharding" semantics — the [R, M, M]
    # variational stacks (q_sqrt term, KL syrk/logdet) shard their R axis
    # over 'model' via the in-op constraints (ops/conditional.py,
    # ops/linalg.py::gauss_kl) while the serial [M, M] factorization
    # stays replicated.  R=10 divides every power-of-two model axis <= 2;
    # larger axes drop the constraint with the documented one-shot warning.
    mflags = BuilderFlags(M='8', feature_maps='', filter_sizes='5',
                          strides='1', num_samples=2,
                          batch_size=2 * n_data, last_kernel='rbf')
    mmodel = build_model(mflags, X, Y, jax.random.PRNGKey(3), dtype=dtype)
    mconfig = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=1000,
                          gamma=0.001, batch_size=mflags.batch_size)
    mpairs = sharded_vs_replicated_elbos(mesh, mmodel, mconfig, xh, yh, 4)
    _check('m1024-geometry R-sharded', mpairs[:1])
    melbo = mpairs[0][0]

    # One legible LAST line for the driver record (the compilation-cache
    # warnings above it are noise).
    elbos = ', '.join(f'{k} elbo={v:.2f}' for k, v in elbo_by_opt.items())
    print(f"MULTICHIP DRYRUN OK: mesh data={n_data} x model={model_axis}, "
          f"2 steps each of [{elbos}] each matching the replicated "
          f"single-device step to rtol {rtol:g}, sharded eval finite, "
          f"m1024-geometry R-sharded step elbo={melbo:.2f} "
          "(also replicated-checked)", flush=True)
