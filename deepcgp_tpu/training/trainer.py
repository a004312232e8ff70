"""Jitted training loop.

The reference's hot loop crosses Python->C++ once per optimizer step
(`conv_gp/experiment.py:38-49`, SURVEY.md §3.1).  Here the whole
``test_every``-step epoch runs as ONE jitted ``lax.scan`` on device: the
minibatch is gathered from the resident training set with on-device PRNG
indices, so there are zero host round-trips between optimizer steps.

Optimizer wiring mirrors `conv_gp/experiment.py:90-111`:
* Adam      — Adam on everything trainable;
* SGD       — plain gradient descent;
* NatGrad   — natural-gradient step on every layer's (q_mu, q_sqrt) plus an
              Adam step on the remaining parameters, both fed from ONE
              ``value_and_grad`` evaluation (the reference runs two
              sequential session actions out of TF-1 necessity,
              `conv_gp/experiment.py:97-108`; the ELBO is the same function,
              so a single backward pass serves both updates).

NatGrad failure recovery is *deferred by one step*: a natural-gradient
proposal can be finite yet push the ELBO into NaN territory, which the
reference catches because its next session.run raises
(`conv_gp/experiment.py:38-49`).  Here each step's loss evaluation doubles
as the verification of the PREVIOUS commit: ``TrainState.prev_model`` holds
the last parameters whose ELBO was observed finite, and a non-finite loss
rolls the model back to it (and bumps ``steps_back`` so the gamma schedule
retries smaller) — same recovery semantics, zero extra passes.
"""

from __future__ import annotations

import functools
import os
import typing

import jax
import jax.numpy as jnp
import optax
from jax import lax

from deepcgp_tpu.training import optim
from deepcgp_tpu.utils import struct


@struct.dataclass
class TrainState:
    model: typing.Any
    opt_state: typing.Any
    step: jax.Array          # global optimizer step (int32)
    steps_back: jax.Array    # NatGrad gamma backoff counter (float)
    key: jax.Array
    # NatGrad only: the last parameters whose ELBO was observed finite
    # (deferred-verification rollback target); () under Adam/SGD.
    prev_model: typing.Any = ()


@struct.dataclass
class TrainConfig:
    optimizer: str = struct.field(pytree_node=False, default='Adam')
    lr: float = struct.field(pytree_node=False, default=0.01)
    lr_decay_steps: int = struct.field(pytree_node=False, default=100000)
    gamma: float = struct.field(pytree_node=False, default=0.001)
    batch_size: int = struct.field(pytree_node=False, default=32)
    # True = the reference's current source; False = the continuous decay
    # its committed result artifacts were trained with (optim.py).
    lr_staircase: bool = struct.field(pytree_node=False, default=True)


def _adam_core():
    # DEEPCGP_ADAM_MOMENT_DTYPE=bfloat16 stores the Adam moments in bf16
    # (update math stays f32 — optim.scale_by_adam_storage): the m1024
    # config's Adam+commit fusions are bandwidth-bound on the f32 moment
    # stacks.
    dt = os.environ.get('DEEPCGP_ADAM_MOMENT_DTYPE', 'auto')
    if dt == 'auto':
        # Per-leaf: bf16 STOCHASTIC-ROUNDING stores for >=2^22-element f32
        # leaves (m1024's bandwidth-bound [10,1024,1024] moment stacks;
        # soak ELBO -173.5 vs f32 -173.6), exact f32
        # for everything else (flagship/CLI states are bit-identical to
        # optax).  Plain RTN bf16 FAILED the soak gate — it freezes the
        # second moment (PARITY.md round-4); SR is unbiased per store.
        return optim.scale_by_adam_storage('auto', b1=0.9, b2=0.999,
                                           eps=1e-8)
    if dt in ('bfloat16', 'bfloat16_sr'):
        return optim.scale_by_adam_storage(jnp.bfloat16, b1=0.9, b2=0.999,
                                           eps=1e-8,
                                           stochastic_round=dt.endswith(
                                               '_sr'))
    return optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)


def init_state(model, config: TrainConfig, key: jax.Array,
               global_step: int = 0) -> TrainState:
    if config.optimizer == 'Adam' or config.optimizer == 'NatGrad':
        opt_state = _adam_core().init(model)
    elif config.optimizer == 'SGD':
        opt_state = ()
    else:
        raise ValueError("Not a supported optimizer. Try Adam or NatGrad.")
    dtype = model.layers[0].q_mu.dtype
    return TrainState(model=model, opt_state=opt_state,
                      step=jnp.asarray(global_step, jnp.int32),
                      steps_back=jnp.asarray(0.0, dtype),
                      key=key,
                      prev_model=model if config.optimizer == 'NatGrad'
                      else ())


def _where_tree(pred, new, old):
    return jax.tree_util.tree_map(
        lambda n, o: jnp.where(pred, n, o), new, old)


def _all_finite(value, tree) -> jax.Array:
    ok = jnp.isfinite(value)
    for leaf in jax.tree_util.tree_leaves(tree):
        ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(leaf)))
    return ok


def train_step(state: TrainState, config: TrainConfig, xb, yb) -> tuple:
    """One optimizer iteration; returns (new_state, elbo_value)."""
    model0 = state.model
    lr = optim.learning_rate_schedule(
        config.lr, config.lr_decay_steps,
        staircase=config.lr_staircase)(state.step)
    steps_back = state.steps_back

    key, k_mc = jax.random.split(state.key)
    loss, grads = jax.value_and_grad(lambda m: -m.elbo(xb, yb, k_mc))(model0)
    loss_ok = jnp.isfinite(loss)

    if config.optimizer == 'NatGrad':
        # Both halves of the step from the ONE gradient evaluation above:
        # natural gradient on (q_mu, q_sqrt), Adam on everything else.
        gamma = optim.gamma_schedule(state.step, steps_back, config.gamma)
        new_layers, _, ng_ok = optim.natgrad_step_with_backoff(
            model0.layers, grads.layers, gamma.astype(xb.dtype), steps_back)
        model_ng = model0.replace(layers=new_layers)
    else:
        ng_ok = jnp.asarray(True)
        model_ng = model0

    mask = optim.trainable_mask(
        model0, exclude_variational=(config.optimizer == 'NatGrad'))
    grads = optim.apply_mask(grads, mask)

    # Numerical-failure guard (the jit-friendly form of the reference's
    # cholesky-failure retry, `conv_gp/experiment.py:38-49`): a step whose
    # loss, gradients, or NatGrad proposal is non-finite is not committed
    # — parameters and optimizer moments stay intact — and in NatGrad mode
    # ``steps_back`` is bumped so the gamma schedule retries smaller.  The
    # failure stays visible as a NaN in the returned ELBO trace.
    #
    # ``ok`` is derived from the MASKED GRADS, not the Adam updates: with
    # finite moments (inductively guaranteed — non-finite grads are never
    # committed), updates are finite iff grads are, so the commit decision
    # is identical — but computing it upstream of the optimizer breaks the
    # update -> check -> select dependency cycle that otherwise forces XLA
    # to materialize both moment trees and re-read them for the is-finite
    # pass (~0.6ms/step at M=1024).
    ok = jnp.logical_and(jnp.logical_and(loss_ok, ng_ok),
                         _all_finite(loss, grads))

    if config.optimizer == 'SGD':
        updates = grads
        new_opt_state = state.opt_state
    else:
        updates, new_opt_state = _adam_core().update(grads, state.opt_state)

    new_model = jax.tree_util.tree_map(
        lambda p, u: p - lr.astype(p.dtype) * u, model_ng, updates)

    if config.optimizer == 'NatGrad':
        # Deferred verification (see module docstring): a finite NatGrad
        # proposal can still break the ELBO; this step's loss evaluation IS
        # the check of the previous commit.  Non-finite loss => the current
        # parameters are poisoned: roll back to the last verified ones.
        new_model = _where_tree(ok, new_model,
                                _where_tree(loss_ok, model0,
                                            state.prev_model))
        new_prev = _where_tree(loss_ok, model0, state.prev_model)
        steps_back = jnp.where(ok, steps_back, steps_back + 1.0)
    else:
        new_model = _where_tree(ok, new_model, model0)
        new_prev = state.prev_model

    new_opt_state = _where_tree(ok, new_opt_state, state.opt_state)
    return state.replace(model=new_model, opt_state=new_opt_state,
                         step=state.step + 1, steps_back=steps_back,
                         key=key, prev_model=new_prev), -loss


def scan_unroll(config: TrainConfig, num_steps: int) -> int:
    """Unroll factor of :func:`run_chunk`'s step scan — the single source of
    truth shared with bench.py's XLA cost-analysis divisor (XLA counts the
    scan BODY once, so the program total is per-step * unroll).

    Unrolling the scan amortizes the while-loop machinery (condition
    evaluation, carry/trace dynamic-update-slices) over more steps per
    iteration, at the cost of compile time.  The per-optimizer defaults
    (Adam 4, NatGrad 2) were tuned on earlier hardware and await an H100
    sweep (ROADMAP C4); DEEPCGP_SCAN_UNROLL overrides."""
    default_unroll = 2 if config.optimizer == 'NatGrad' else 4
    unroll = int(os.environ.get('DEEPCGP_SCAN_UNROLL', default_unroll))
    while unroll > 1 and num_steps % unroll:
        unroll //= 2
    return max(unroll, 1)


def run_chunk_impl(state: TrainState, config: TrainConfig, X_train, Y_train,
                   num_steps: int):
    """Traced body of :func:`run_chunk` — ``num_steps`` optimizer iterations
    as one on-device scan.  Minibatches are uniform random with replacement
    (gpflow Minibatch semantics).  Returns (state, elbo trace [num_steps]).

    Plain (un-jitted) so the mesh path (parallel/train.py) can re-trace it
    under a mesh context without reaching into jit internals."""
    N = X_train.shape[0]
    # For small resident sets the minibatch rows are selected by a one-hot
    # matmul, bitwise identical to a gather (one-hot rows are exact at
    # HIGHEST; pinned by test_training.py::test_onehot_gather_bitwise).
    # The matmul costs 2*B*N*D flops, so past ~8M table elements (e.g. full
    # 60k-row MNIST) the gather takes over.  Which is faster on the H100 is
    # open (ROADMAP C3).
    use_onehot = N * X_train.shape[1] <= 8_000_000

    def _rows(table, idx):
        if use_onehot:
            oh = jax.nn.one_hot(idx, N, dtype=X_train.dtype)
            return lax.dot_general(
                oh, table.astype(X_train.dtype), (((1,), (0,)), ((), ())),
                precision=lax.Precision.HIGHEST).astype(table.dtype)
        return jnp.take(table, idx, axis=0)

    def body(state, _):
        key, kb = jax.random.split(state.key)
        idx = jax.random.randint(kb, (config.batch_size,), 0, N)
        xb = _rows(X_train, idx)
        yb = _rows(Y_train, idx)
        state, elbo = train_step(state.replace(key=key), config, xb, yb)
        return state, elbo

    state, elbos = lax.scan(body, state, length=num_steps,
                            unroll=scan_unroll(config, num_steps))

    if config.optimizer == 'NatGrad':
        # Terminal verification: the deferred NatGrad check means the LAST
        # committed proposal is still unverified when the chunk returns —
        # without this, a finite-but-poisonous final step would reach eval
        # and the persisted .npy snapshot (and on the run's last chunk it
        # would never be rolled back at all).  One extra ELBO evaluation
        # per chunk; non-finite -> roll back to the last verified params.
        key, kb, k_mc = jax.random.split(state.key, 3)
        idx = jax.random.randint(kb, (config.batch_size,), 0, N)
        loss = -state.model.elbo(_rows(X_train, idx), _rows(Y_train, idx),
                                 k_mc)
        ok = jnp.isfinite(loss)
        state = state.replace(
            model=_where_tree(ok, state.model, state.prev_model), key=key)

    return state, elbos


run_chunk = jax.jit(run_chunk_impl, static_argnames=('config', 'num_steps'))


# --------------------------------------------------------------- evaluation
@functools.partial(jax.jit, static_argnames=('num_samples',))
def predict_probs(model, X, key, num_samples: int = 5):
    """Mean class probabilities over MC samples, [N, K]
    (`conv_gp/utils/log.py:62-66`)."""
    probs, _ = model.predict_y(X, key, num_samples)
    return jnp.mean(probs, axis=0)


def predict_probs_impl(model, X, key, batch_size: int = 32,
                       num_samples: int = 5):
    """Traced body of :func:`predict_probs_scanned` (plain, so the mesh eval
    path can re-trace it under a mesh context) — whole-set prediction as ONE
    program: a lax.scan over fixed-size batches (pad + reshape), so an eval
    over the full test set costs one dispatch instead of N/batch host
    round-trips."""
    N = X.shape[0]
    n_batches = -(-N // batch_size)
    pad = n_batches * batch_size - N
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    Xb = Xp.reshape(n_batches, batch_size, X.shape[1])
    # Under an active mesh, shard each scanned batch's rows over 'data' (the
    # in-layer constraints handle 'model'); no-op single-device.  Without
    # this pin GSPMD tends to shard the SCAN axis, serializing the mesh.
    from deepcgp_tpu.parallel import sharding
    Xb = sharding.constrain(Xb, None, 'data', None)

    def body(key, xb):
        key, sub = jax.random.split(key)
        probs, _ = model.predict_y(xb, sub, num_samples)
        return key, jnp.mean(probs, axis=0)

    _, probs = lax.scan(body, key, Xb)
    return probs.reshape(n_batches * batch_size, -1)[:N]


predict_probs_scanned = jax.jit(
    predict_probs_impl, static_argnames=('batch_size', 'num_samples'))


def correct_count_from_probs(probs, Y) -> jax.Array:
    """Count of argmax predictions matching labels Y [N, 1] — the single
    definition shared by the host-side and mesh-sharded accuracy paths
    (`conv_gp/utils/log.py:50-68` semantics).  Returns the integer COUNT
    (an on-device replicated scalar, so it crosses process boundaries);
    callers divide by Y.size in host float64 for a clean fraction."""
    pred = jnp.argmax(probs, axis=1)[:, None]
    return jnp.sum(pred == Y)


def accuracy(model, X_test, Y_test, key, batch_size: int = 32,
             num_samples: int = 5) -> float:
    """Batched test accuracy (`conv_gp/utils/log.py:50-68`): mean class
    probability over ``num_samples`` MC draws per batch of ``batch_size``,
    argmax, fraction correct — evaluated on device in one scanned program."""
    probs = predict_probs_scanned(
        model, jnp.asarray(X_test), key, batch_size, num_samples)
    count = correct_count_from_probs(probs, jnp.asarray(Y_test))
    return float(count) / Y_test.size
