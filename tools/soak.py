"""NatGrad / Adam soak on LEARNABLE synthetic data (PARITY.md evidence).

The bench's random data is unlearnable noise; the soak instead trains on
separable Gaussian blobs so optimizer health is observable: the run must
stay NaN-free (steps_back == 0), the ELBO must improve, and train accuracy
must reach ~1.0.  Round-2 ran the same protocol; this script re-establishes
the evidence after the round-3 math changes (rbg sampling, S-fold,
patch-matmul cross-covariances, aggregate-then-solve KL trace).

Usage (one process per accelerator):
    python tools/soak.py --config flagship --steps 10000 > soak_flagship.log
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def blobs(n, shape, classes, seed):
    """Shared with bench.py's numerics probe — see data.learnable_blobs."""
    from deepcgp_tpu.training.data import learnable_blobs
    return learnable_blobs(n, shape, classes, seed)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default='flagship',
                    choices=['flagship', 'm1024'])
    ap.add_argument('--optimizer', default='NatGrad')
    ap.add_argument('--steps', type=int, default=10000)
    ap.add_argument('--chunk', type=int, default=500)
    ap.add_argument('--seed', type=int, default=0,
                    help='init/train PRNG offset — vary to measure the '
                         'seed-to-seed chaos envelope a precision gate '
                         'compares against (data blobs stay fixed)')
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig

    if args.config == 'm1024':
        flags = BuilderFlags(M='1024', feature_maps='', filter_sizes='5',
                             strides='1', num_samples=10, batch_size=128,
                             last_kernel='rbf')
        X, Y = blobs(2048, (28, 28, 1), 10, 0)
    else:
        flags = BuilderFlags(M='384,384', feature_maps='10',
                             filter_sizes='5,5', strides='3,1',
                             num_samples=10, batch_size=32)
        X, Y = blobs(2048, (32, 32, 3), 10, 0)

    print(f"devices: {jax.devices()}", flush=True)
    t0 = time.time()
    model = build_model(flags, X, Y, jax.random.PRNGKey(100 * args.seed),
                        dtype=jnp.float32)
    print(f"model built in {time.time() - t0:.1f}s", flush=True)
    config = TrainConfig(optimizer=args.optimizer, lr=0.01,
                         lr_decay_steps=100000, gamma=0.001,
                         batch_size=flags.batch_size)
    state = trainer.init_state(model, config,
                               jax.random.PRNGKey(100 * args.seed + 1))
    Xd = jnp.asarray(X.reshape(X.shape[0], -1))
    Yd = jnp.asarray(Y)

    nan_steps = 0
    t0 = time.time()
    done = 0
    while done < args.steps:
        state, elbos = trainer.run_chunk(state, config, Xd, Yd, args.chunk)
        e = np.asarray(elbos)
        nan_steps += int(np.sum(~np.isfinite(e)))
        done += args.chunk
        sps = done / (time.time() - t0)
        print(f"step {done}: elbo {float(e[-1]):.1f} "
              f"(mean {float(np.nanmean(e)):.1f}), "
              f"steps_back {float(state.steps_back):.0f}, "
              f"nan_steps {nan_steps}, {sps:.0f} steps/s", flush=True)

    acc = trainer.accuracy(state.model, np.asarray(Xd), Y,
                           jax.random.PRNGKey(9), batch_size=128,
                           num_samples=5)
    ok = (nan_steps == 0 and float(state.steps_back) == 0.0
          and np.isfinite(float(np.asarray(elbos)[-1])))
    print(f"SOAK {'OK' if ok else 'FAIL'}: {args.config} {args.optimizer} "
          f"{args.steps} steps, nan_steps={nan_steps}, "
          f"steps_back={float(state.steps_back):.0f}, "
          f"train_accuracy={acc:.3f}, final elbo "
          f"{float(np.asarray(elbos)[-1]):.1f}", flush=True)


if __name__ == '__main__':
    main()
