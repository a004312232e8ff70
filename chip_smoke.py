"""Smoke test of the training and serving path on one NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(f) on one card
    python chip_smoke.py --four-cards  # phase (g) alone, on four cards

Phases, all in this one process (a JAX process reserves most of the card's
memory, so a second one would fail):

  a. device check: JAX's first device is a GPU (never falls back to CPU);
  b. flagship CIFAR-10 2-layer config (M=384,384, C=10, S=10, batch 32)
     with Adam through ``deepcgp_tpu.cifar.main`` on the synthetic fallback;
  c. the same config with NatGrad;
  d. MNIST M=1024 (single RBF SVGP layer, batch 128) with NatGrad;
  e. ``serving.Predictor.from_run_dir`` on run (b) answers 3 requests;
  f. the flagship ELBO and gradient norm at initialization in float32 on
     the GPU against float64 on the CPU, plus one Kuu inverse apply at each
     matmul precision against float64;
  g. (``--four-cards`` only) phase (b)'s config with ``--mesh data=4``, and
     one sharded training step against the same step on one card.

Tests marked ``gpu`` run first, in a subprocess that exits before this
process opens the card.  Every phase prints its wall and compile time; the
last line is one JSON object naming the device.  Any failure exits non-zero
without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = ['-M', '384,384', '--feature-maps', '10', '--filter-sizes', '5,5',
            '--strides', '3,1', '--num-samples', '10', '--batch-size', '32']
M1024 = ['-M', '1024', '--feature-maps', '', '--filter-sizes', '5',
         '--strides', '1', '--last-kernel', 'rbf', '--num-samples', '10',
         '--batch-size', '128']
# -N within the synthetic fallback's 6,000 rows; chunks of test_every steps,
# ceil(lr_decay_steps * log10(lr / 5e-5) / test_every) = 3 of them.
RUN = ['-N', '6000', '--test-size', '500', '--no-tensorboard']


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Raise unless ``ok``: the script's checks must hold under ``-O``."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ------------------------------------------------------------ timing


class CompileClock:
    """Sums JAX's compile-event durations (tracing, lowering, backend
    compile) so each phase can report its compile time."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **kwargs) -> None:
        if event.startswith('/jax/core/compile/'):
            self.total += duration


@contextlib.contextmanager
def phase(name: str, clock: CompileClock | None):
    log(f"[{name}] start")
    t0, c0 = time.time(), (clock.total if clock else 0.0)
    yield
    compile_s = (clock.total - c0) if clock else float('nan')
    log(f"[{name}] ok: wall {time.time() - t0:.1f}s, "
        f"compile {compile_s:.1f}s")


# ----------------------------------------------------------- pre-flight


def card_identity() -> str | None:
    """``name, power.limit`` of every card, as nvidia-smi reports them;
    None when nvidia-smi finds no card."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def run_gpu_tests() -> None:
    """Tests marked ``gpu``, in a subprocess that owns the card while it
    runs.  Under DEEPCGP_TEST_PLATFORM=gpu a missing card fails them."""
    env = dict(os.environ, DEEPCGP_TEST_PLATFORM='gpu')
    rc = subprocess.run(
        [sys.executable, '-m', 'pytest', '-m', 'gpu', '-q', '-rs',
         '-p', 'no:cacheprovider', os.path.join(HERE, 'tests')],
        env=env, cwd=HERE, timeout=600).returncode
    if rc == 5:                         # no test carries the marker
        log("gpu tests: none collected")
    elif rc != 0:
        raise RuntimeError(f"gpu tests failed (rc {rc})")


def check_device(devices) -> None:
    """Phase (a): the first device must be a GPU."""
    if not devices or devices[0].platform != 'gpu':
        raise RuntimeError(
            f"no GPU: JAX's devices are {devices}; this script never falls "
            "back to the CPU")


# -------------------------------------------------------------- phases


def check_run_dir(log_dir: str, name: str) -> list:
    """``log.csv`` has finite train ELBOs and a test accuracy per entry, and
    the ``<name>.npy`` snapshot exists.  Returns the CSV rows."""
    with open(os.path.join(log_dir, name, 'log.csv')) as f:
        rows = list(csv.DictReader(f))
    check(rows, f"{name}: empty log.csv")
    for r in rows:
        check(math.isfinite(float(r['train_elbo'])), (name, r))
        check(0.0 <= float(r['test_accuracy']) <= 1.0, (name, r))
    check(os.path.exists(os.path.join(log_dir, name + '.npy')),
          f"{name}.npy written")
    log(f"{name}: " + '; '.join(
        f"step {r['global_step']} elbo {float(r['train_elbo']):.3f} "
        f"acc {float(r['test_accuracy']):.3f}" for r in rows))
    return rows


def step_report(exp, name: str) -> None:
    """Memory analysis of the compiled training chunk, and the steps/s of
    one more chunk after the run (a first reading, not a baseline)."""
    import jax

    from deepcgp_tpu.training import trainer
    n = exp.flags.test_every
    compiled = trainer.run_chunk.lower(
        exp.state, exp.config, exp.X_train_dev, exp.Y_train_dev,
        n).compile()
    log(f"{name} memory_analysis: {compiled.memory_analysis()}")
    t0 = time.time()
    _, elbos = trainer.run_chunk(exp.state, exp.config, exp.X_train_dev,
                                 exp.Y_train_dev, n)
    jax.block_until_ready(elbos)
    log(f"{name} steps/s: {n / (time.time() - t0):.1f} "
        f"({n}-step chunk after the run)")


def train(module, name: str, args: list, log_dir: str, report=True):
    exp = module.main(['--name', name, '--log-dir', log_dir] + args + RUN)
    check_run_dir(log_dir, name)
    if report:
        step_report(exp, name)
    return exp


def serve(run_dir: str, exp) -> None:
    """Phase (e): three requests of different sizes."""
    from deepcgp_tpu.serving import Predictor
    pred = Predictor.from_run_dir(run_dir, exp.X_train, exp.Y_train,
                                  batch_size=32, num_samples=5)
    for n in (1, 17, 100):
        t0 = time.time()
        probs = pred.predict_proba(
            exp.X_test[np.arange(n) % len(exp.X_test)])
        check(probs.shape == (n, 10), probs.shape)
        check(np.isfinite(probs).all(), f"finite probabilities, {n} rows")
        # Robust-max class probabilities come from Gauss-Hermite
        # quadrature, so rows sum to 1 to quadrature accuracy.
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=5e-3)
        log(f"serve {n} rows: {time.time() - t0:.3f}s")


def rel(a, b) -> float:
    """Relative Frobenius difference of ``a`` from the reference ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def compare_with_reference(exp) -> None:
    """Phase (f): float32 on the GPU against float64 on the CPU."""
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models import dgp

    # The same Monte-Carlo noise on both sides: float32 threefry draws
    # (identical bits on every backend), cast to the model dtype.
    rbg_normal = dgp.mc_normal
    dgp.mc_normal = lambda key, shape, dtype: jax.random.normal(
        key, shape, jnp.float32).astype(dtype)
    try:
        _compare(exp)
    finally:
        dgp.mc_normal = rbg_normal


def _compare(exp) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from deepcgp_tpu.ops import linalg
    from deepcgp_tpu.utils.diagnostics import cast_model


    model = exp.model                     # the flagship at initialization
    B = exp.flags.batch_size
    xb = np.asarray(exp.X_train[:B].reshape(B, -1), np.float32)
    yb = np.asarray(exp.Y_train[:B])
    key = jax.random.PRNGKey(7)

    def loss(m, x, y, k):
        return -m.elbo(x, y, k)

    vg = jax.jit(jax.value_and_grad(loss))

    def elbo_and_grad_norm(m, x, y, k):
        val, grads = vg(m, x, y, k)
        leaves = jax.tree_util.tree_leaves(grads)
        norm = math.sqrt(sum(float(jnp.sum(jnp.square(g)))
                             for g in leaves))
        return -float(val), norm

    elbo32, gnorm32 = elbo_and_grad_norm(model, jnp.asarray(xb),
                                         jnp.asarray(yb), key)

    # One Kuu inverse apply (ops/conditional.py: A = Kuf Lm^-T), float32 on
    # the GPU at each precision, against float64 numpy on the same inputs.
    layer = model.layers[0]
    Kuu = np.asarray(jax.jit(lambda L: L.conv_kernel.Kuu(L.Z))(layer),
                     np.float64)
    Lm_inv = np.linalg.inv(np.linalg.cholesky(Kuu))
    NHWC = jnp.asarray(exp.X_train[:B])
    Kuf = np.asarray(jax.jit(lambda L, x: L.conv_kernel.Kuf_PNM(
        L.Z, jnp.swapaxes(L.view.extract_patches_NPL(x), 0, 1)))(
            layer, NHWC), np.float64)                       # [P, N, M]
    want = np.einsum('pnm,sm->pns', Kuf, Lm_inv)
    apply_err = {}
    for pname, prec in (('DEFAULT', lax.Precision.DEFAULT),
                        ('HIGH', lax.Precision.HIGH),
                        ('HIGHEST', lax.Precision.HIGHEST)):
        got = jax.jit(lambda a, b, p=prec: jnp.einsum(
            'pnm,sm->pns', a, b, precision=p))(
                jnp.asarray(Kuf, jnp.float32),
                jnp.asarray(Lm_inv, jnp.float32))
        apply_err[pname] = rel(got, want)
        log(f"inverse apply [{Kuf.shape[0] * Kuf.shape[1]},{Kuf.shape[2]}]"
            f"x[{Lm_inv.shape[0]},{Lm_inv.shape[1]}] f32 {pname}: "
            f"rel diff {apply_err[pname]:.3e} from float64")

    # float64 reference on the CPU.  Enabled last: x64 must not change the
    # dtypes of the float32 phases above.
    jax.config.update('jax_enable_x64', True)
    cpu = jax.devices('cpu')[0]
    model64 = jax.device_put(cast_model(model, jnp.float64), cpu)
    elbo64, gnorm64 = elbo_and_grad_norm(
        model64, jax.device_put(xb.astype(np.float64), cpu),
        jax.device_put(yb, cpu), jax.device_put(key, cpu))

    chosen = {lax.Precision.DEFAULT: 'DEFAULT', lax.Precision.HIGH: 'HIGH',
              lax.Precision.HIGHEST: 'HIGHEST'}[linalg._INV_PRECISION]
    checks = [
        # The repo's float32-vs-float64 ELBO gate (utils/diagnostics.py):
        # float32 rounding, TF32 (~1e-3 relative product error) in the
        # DEFAULT-precision cross-covariance matmuls, and the GPU's other
        # order of sums must stay inside it.
        ('ELBO', abs(elbo32 - elbo64) / abs(elbo64), 1e-4,
         f"f32 GPU {elbo32:.8g} vs f64 CPU {elbo64:.8g}"),
        # Gradients add the backward's TF32 products on top of the
        # forward's, and flow through the factor inverses.
        ('grad norm', abs(gnorm32 - gnorm64) / gnorm64, 1e-3,
         f"f32 GPU {gnorm32:.8g} vs f64 CPU {gnorm64:.8g}"),
        # The inverse apply at the precision the code uses: float32 rounding
        # of the inputs plus a float32 product, amplified by the
        # cancellation in Kuf Lm^-T; a TF32 product would be far larger.
        (f'inverse apply at {chosen}', apply_err[chosen], 1e-4,
         "f32 GPU vs f64 numpy"),
    ]
    failed = []
    for what, d, tol, detail in checks:
        log(f"compare {what}: {detail}, rel diff {d:.3e} "
            f"(tolerance {tol:g})")
        if not d <= tol:
            failed.append(what)
    check(not failed, f"outside tolerance: {failed}")


def four_cards(log_dir: str) -> None:
    """Phase (g): the flagship over a data=4 mesh, then one sharded training
    step against the same step on one card."""
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu import cifar
    from deepcgp_tpu.parallel import mesh as mesh_lib
    from deepcgp_tpu.parallel.train import sharded_vs_replicated_elbos

    exp = train(cifar, 'flagship_mesh', FLAGSHIP + [
        '--optimizer', 'Adam', '--mesh', 'data=4', '--test-every', '50',
        '--lr-decay-steps', '50'], log_dir, report=False)
    B = exp.flags.batch_size
    xb = jnp.asarray(exp.X_train[:B].reshape(B, -1))
    yb = jnp.asarray(exp.Y_train[:B])
    pairs = sharded_vs_replicated_elbos(
        mesh_lib.make_mesh('data=4'), exp.model, exp.config, xb, yb)
    rtol = 1e-4            # parallel/train.py's float32 tolerance
    for i, (got, want) in enumerate(pairs, 1):
        d = abs(got - want) / max(abs(want), 1.0)
        log(f"step {i}: 4-card ELBO {got:.8g} vs 1-card {want:.8g}, "
            f"rel diff {d:.3e} (tolerance {rtol:g})")
        check(math.isfinite(got) and d <= rtol, (i, got, want))
    check(len(jax.devices()) == 4, jax.devices())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help="run phase (g) on four cards instead of (a)-(f)")
    args = ap.parse_args(argv)

    card = card_identity()
    log(card or "nvidia-smi: no card found")
    if card and not args.four_cards:
        run_gpu_tests()

    import jax
    log(f"jax {jax.__version__}")
    with phase('a: device check', None):
        devices = jax.devices()
        check_device(devices)
        log(f"devices: {devices}")
    from deepcgp_tpu import cifar, compilation_cache_dir, mnist
    log(f"compile cache: {compilation_cache_dir()}")
    clock = CompileClock()

    with tempfile.TemporaryDirectory() as tmp:
        runs = os.path.join(tmp, 'runs')
        if args.four_cards:
            with phase('g: four cards', clock):
                four_cards(runs)
        else:
            chunks = ['--test-every', '50', '--lr-decay-steps', '50']
            with phase('b: flagship Adam', clock):
                flagship = train(cifar, 'flagship', FLAGSHIP + chunks + [
                    '--optimizer', 'Adam'], runs)
            with phase('c: flagship NatGrad', clock):
                train(cifar, 'flagship_ng', FLAGSHIP + chunks + [
                    '--optimizer', 'NatGrad'], runs)
            with phase('d: MNIST M=1024 NatGrad', clock):
                train(mnist, 'm1024_ng', M1024 + [
                    '--optimizer', 'NatGrad', '--test-every', '20',
                    '--lr-decay-steps', '20'], runs)
            with phase('e: serving', clock):
                serve(os.path.join(runs, 'flagship'), flagship)
            with phase('f: float64 reference', clock):
                compare_with_reference(flagship)

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
