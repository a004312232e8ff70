"""NatGrad-vs-Adam convergence sweep on REAL data (UCI digits).

On the fixed digits split the 2-layer NatGrad run
trailed Adam by 1.7 accuracy points (0.9749 vs 0.9916 converged) with
zero tuning.  The reference's machinery (gamma annealing + backoff,
`conv_gp/experiment.py:74-80,90-108`) exists to make NatGrad the BETTER
variational optimizer, so this sweeps the knobs the reference exposes —
gamma0, whitening, and an Adam warm-start — on the identical split and
schedule, tracking held-out accuracy at every eval epoch plus the
steps_back backoff counter (is it step size, whitening, or a genuine
optimum?).

All configs run inside ONE process (one JAX process per accelerator); the
per-config programs differ only in static TrainConfig fields, so reruns hit
the persistent compile cache.

Usage:  python tools/natgrad_digits.py > ng_digits.log
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _flags(white=False):
    return SimpleNamespace(N=1438, test_size=359, seed=0, M='64,64',
                           feature_maps='10', filter_sizes='3,3',
                           strides='1,1', num_samples=10, batch_size=64,
                           base_kernel='rbf', white=white,
                           last_kernel='conv', identity_mean=False)


def run_config(tag, *, optimizer, gamma0, white=False, warm_adam_steps=0,
               total_steps=4000, eval_every=500, lr=0.01,
               lr_decay_steps=7000, seed=1):
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.builder import build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.data import digits_data
    from deepcgp_tpu.training.trainer import TrainConfig

    f = _flags(white=white)
    xtr, ytr, xte, yte = digits_data(f)
    model = build_model(f, xtr, ytr, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    Xd = jnp.asarray(xtr.reshape(len(xtr), -1))
    Yd = jnp.asarray(ytr)

    if warm_adam_steps:
        cfg_a = TrainConfig(optimizer='Adam', lr=lr,
                            lr_decay_steps=lr_decay_steps, gamma=gamma0,
                            batch_size=f.batch_size)
        st = trainer.init_state(model, cfg_a, jax.random.PRNGKey(seed))
        st, _ = trainer.run_chunk(st, cfg_a, Xd, Yd, warm_adam_steps)
        model = st.model

    config = TrainConfig(optimizer=optimizer, lr=lr,
                         lr_decay_steps=lr_decay_steps, gamma=gamma0,
                         batch_size=f.batch_size)
    state = trainer.init_state(model, config, jax.random.PRNGKey(seed))

    accs, elbos = [], []
    peak = 0.0
    t0 = time.time()
    for step in range(0, total_steps, eval_every):
        state, el = trainer.run_chunk(state, config, Xd, Yd, eval_every)
        acc = trainer.accuracy(state.model, xte.reshape(len(xte), -1), yte,
                               jax.random.PRNGKey(9), batch_size=128,
                               num_samples=5)
        accs.append(round(acc, 4))
        elbos.append(round(float(el[-1]), 1))
        peak = max(peak, acc)
    out = {
        'tag': tag, 'optimizer': optimizer, 'gamma0': gamma0,
        'white': white, 'warm_adam_steps': warm_adam_steps,
        'final_acc': accs[-1], 'peak_acc': round(peak, 4),
        'steps_back': float(state.steps_back),
        'accs': accs, 'elbos': elbos,
        'wall_s': round(time.time() - t0, 1),
    }
    _log(f"[{tag}] {json.dumps(out)}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=4000)
    ap.add_argument('--eval-every', type=int, default=500)
    ap.add_argument('--only', default=None,
                    help='comma list of tags to run')
    args = ap.parse_args()

    import jax
    _log(f"devices: {jax.devices()}")

    sweeps = [
        ('adam', dict(optimizer='Adam', gamma0=0.001)),
        ('ng-g1e-3', dict(optimizer='NatGrad', gamma0=0.001)),
        ('ng-g1e-2', dict(optimizer='NatGrad', gamma0=0.01)),
        ('ng-g3e-2', dict(optimizer='NatGrad', gamma0=0.03)),
        ('ng-g1e-1', dict(optimizer='NatGrad', gamma0=0.1)),
        ('ng-g1e-2-white', dict(optimizer='NatGrad', gamma0=0.01,
                                white=True)),
        ('ng-g1e-2-warm500', dict(optimizer='NatGrad', gamma0=0.01,
                                  warm_adam_steps=500)),
    ]
    only = set(args.only.split(',')) if args.only else None
    results = []
    for tag, kw in sweeps:
        if only and tag not in only:
            continue
        try:
            results.append(run_config(tag, total_steps=args.steps,
                                      eval_every=args.eval_every, **kw))
        except Exception as e:  # keep the sweep going; record the failure
            _log(f"[{tag}] FAILED: {e!r}")
            results.append({'tag': tag, 'error': repr(e)})
    print(json.dumps(results, indent=1))


if __name__ == '__main__':
    main()
