"""Device times of XLA's route for three roles of the training step, on the
accelerator, at the benchmark shapes:

* Kuu factor and inverse (``linalg.chol_with_inv``) on the flagship
  [3, 384, 384] stack, forward and forward+backward;
* the NatGrad update (factor of G, W R^-T, mu) on [20, 384, 384] (flagship)
  and [10, 1024, 1024] (MNIST M=1024);
* the last layer's extraction -> Kzx/Kdiag under ``jax.checkpoint`` at the
  flagship shape (N = batch 32 x S 10 rows of 10x10x10 images, M=384),
  forward and forward+backward.

Each role is timed alone (median of repeated jitted calls, each ending in
``block_until_ready``).  Then a profiler trace of a few steps of the real
training chunks (flagship Adam and NatGrad, MNIST M=1024 NatGrad) is reduced
to device time per kernel name, per step, so the factorization kernels can
be read inside the step.

    python tools/role_times.py
"""

from __future__ import annotations

import collections
import glob
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, *args, reps: int = 20) -> float:
    """Median wall time of ``fn(*args)`` in microseconds, after a warm-up
    call that compiles it."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e6 * float(np.median(times))


def standalone() -> None:
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.base_kernels import RBF
    from deepcgp_tpu.models.conv_kernels import ConvKernel
    from deepcgp_tpu.models.layers import _svgp_kuf_kdiag
    from deepcgp_tpu.models.views import FullView
    from deepcgp_tpu.ops import linalg
    from deepcgp_tpu.training import optim

    rng = np.random.RandomState(0)

    def spd(B, M):
        A = rng.randn(B, M, M).astype(np.float32)
        return jnp.asarray(A @ np.swapaxes(A, -1, -2) / M
                           + 0.5 * np.eye(M, dtype=np.float32))

    K = spd(3, 384)
    fwd = jax.jit(linalg.chol_with_inv)
    bwd = jax.jit(jax.grad(lambda k: sum(jnp.sum(jnp.sin(x))
                                         for x in linalg.chol_with_inv(k))))
    print(f"chol_with_inv [3,384,384] fwd: {timed(fwd, K):.1f} us", flush=True)
    print(f"chol_with_inv [3,384,384] fwd+bwd: {timed(bwd, K):.1f} us",
          flush=True)

    for R, M in ((20, 384), (10, 1024)):
        q_sqrt = jnp.linalg.cholesky(spd(R, M))
        args = (jnp.asarray(rng.randn(M, R), jnp.float32), q_sqrt,
                jnp.asarray(rng.randn(M, R), jnp.float32),
                jnp.asarray(1e-3 * rng.randn(R, M, M), jnp.float32),
                jnp.float32(1e-3))
        ng = jax.jit(optim.natgrad_update)
        out = ng(*args)
        assert all(bool(jnp.all(jnp.isfinite(o))) for o in out)
        print(f"natgrad_update [{R},{M},{M}]: {timed(ng, *args):.1f} us",
              flush=True)

    view = FullView(input_size=(10, 10), filter_size=5, feature_maps=10,
                    stride=1)
    kern = ConvKernel.create(RBF.create(variance=5.0, lengthscales=5.0),
                             view)
    Z = jnp.asarray(rng.randn(384, view.patch_length), jnp.float32)
    X = jnp.asarray(rng.randn(320, 1000), jnp.float32)
    remat = jax.checkpoint(_svgp_kuf_kdiag)
    f = jax.jit(remat)
    g = jax.jit(jax.grad(lambda k, z, x: sum(
        jnp.sum(jnp.sin(o)) for o in remat(k, z, x)), argnums=(0, 1, 2)))
    print(f"last-layer Kzx/Kdiag [320 x 36 patches, M=384] fwd: "
          f"{timed(f, kern, Z, X):.1f} us", flush=True)
    print(f"last-layer Kzx/Kdiag [320 x 36 patches, M=384] fwd+bwd: "
          f"{timed(g, kern, Z, X):.1f} us", flush=True)


def device_kernel_times(trace_dir: str) -> collections.Counter:
    """Total device time (us) per kernel name over every device plane of
    the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(
        trace_dir, 'plugins', 'profile', '*', '*.xplane.pb')))[-1]
    data = ProfileData.from_file(path)
    totals = collections.Counter()
    for plane in data.planes:
        if not plane.name.startswith('/device:'):
            continue
        names = [line.name for line in plane.lines]
        print(f"  trace plane {plane.name}: lines {names}", flush=True)
        for line in plane.lines:
            # Kernels run on the stream lines; the derived per-module and
            # per-op lines re-cover the same time.
            if not line.name.startswith('Stream'):
                continue
            for ev in line.events:
                totals[ev.name] += ev.duration_ns / 1e3
    return totals


def in_step(trace_root: str) -> None:
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.builder import BuilderFlags, build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig

    rng = np.random.RandomState(0)
    flagship = BuilderFlags(M='384,384', feature_maps='10',
                            filter_sizes='5,5', strides='3,1',
                            num_samples=10, batch_size=32)
    m1024 = BuilderFlags(M='1024', feature_maps='', filter_sizes='5',
                         strides='1', num_samples=10, batch_size=128,
                         last_kernel='rbf')
    cifar = rng.randn(2048, 32, 32, 3).astype(np.float32)
    mnist = rng.randn(2048, 28, 28, 1).astype(np.float32)
    Y = rng.randint(0, 10, size=(2048, 1))
    steps = 20
    for tag, flags, opt, X in (('flagship-adam', flagship, 'Adam', cifar),
                               ('flagship-natgrad', flagship, 'NatGrad',
                                cifar),
                               ('m1024-natgrad', m1024, 'NatGrad', mnist)):
        model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                            dtype=jnp.float32)
        config = TrainConfig(optimizer=opt, lr=0.01, lr_decay_steps=100000,
                             gamma=0.001, batch_size=flags.batch_size)
        state = trainer.init_state(model, config, jax.random.PRNGKey(1))
        Xd, Yd = jnp.asarray(X.reshape(len(X), -1)), jnp.asarray(Y)
        state, e = trainer.run_chunk(state, config, Xd, Yd, steps)
        jax.block_until_ready(e)
        t0 = time.perf_counter()
        state, e = trainer.run_chunk(state, config, Xd, Yd, steps)
        jax.block_until_ready(e)
        wall = 1e6 * (time.perf_counter() - t0) / steps
        trace_dir = os.path.join(trace_root, tag)
        with jax.profiler.trace(trace_dir):
            state, e = trainer.run_chunk(state, config, Xd, Yd, steps)
            jax.block_until_ready(e)
        totals = device_kernel_times(trace_dir)
        busy = sum(totals.values()) / steps
        print(f"[{tag}] wall {wall:.1f} us/step, summed kernel time "
              f"{busy:.1f} us/step over {steps} traced steps", flush=True)
        groups = collections.Counter()
        for name, us in totals.items():
            low = name.lower()
            key = ('potrf (Cholesky)' if 'potrf' in low else
                   'trsm (triangular solve)' if 'trsm' in low else
                   'other')
            groups[key] += us / steps
        for key, us in groups.most_common():
            print(f"[{tag}]   {key}: {us:.1f} us/step", flush=True)
        for name, us in totals.most_common(15):
            print(f"[{tag}]   {us / steps:9.1f} us/step  {name[:110]}",
                  flush=True)


def main() -> None:
    import subprocess
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'],
                          capture_output=True, text=True)
    print(f"card: {card.stdout.strip() or 'not reported'}", flush=True)
    import jax
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}",
          flush=True)
    standalone()
    with tempfile.TemporaryDirectory() as tmp:
        in_step(tmp)


if __name__ == '__main__':
    main()
