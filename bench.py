"""Benchmark: optimizer steps/sec on the flagship CIFAR-10 2-layer deep
conv-GP config (reference `notebooks/data/cifar_fm10/options.toml`:
M=384,384, feature_maps=10, filters 5,5, strides 3,1, Adam, batch 32,
num_samples 10).

Baseline: 2.14 steps/sec on the reference authors' cluster GPU
(BASELINE.md, derived from notebooks/data/cifar_fm10.json).

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline"}
for the flagship Adam config, plus keys for the NatGrad-flagship and
M=1024-MNIST configs and per-config MFU.  stderr carries the efficiency
story (SURVEY.md §7.9): analytic TFLOP/step, achieved TFLOP/s, MFU against
the device's TF32 peak (utils/flops.py), and XLA's own cost-analysis flops
as a cross-check.  Set DEEPCGP_BENCH_FAST=1 to skip the secondary configs.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_STEPS_PER_SEC = 2.14


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _bench_config(tag, flags, optimizer, X, Y, steps=None):
    """Build + warm up + time one config; returns (steps/s, analytic MFU
    diagnostics dict).  Emits breadcrumbs + the efficiency line on stderr.
    Each timed chunk is one jitted scan of ``steps`` optimizer steps
    (DEEPCGP_BENCH_CHUNK overrides the length)."""
    if steps is None:
        steps = int(os.environ.get('DEEPCGP_BENCH_CHUNK', 4800))
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.builder import build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig
    from deepcgp_tpu.utils import flops as flops_lib

    N = X.shape[0]
    t0 = time.time()
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    _log(f"[{tag}] model built in {time.time() - t0:.1f}s")

    config = TrainConfig(optimizer=optimizer, lr=0.01,
                         lr_decay_steps=100000, gamma=0.001,
                         batch_size=flags.batch_size)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(N, -1))
    Yd = jnp.asarray(Y)

    # Warmup (compile + first execution).  num_steps is a static arg of the
    # jitted scan, so the warmup chunk MUST have the same length as the timed
    # one or the timing silently includes a fresh compile.
    t0 = time.time()
    state, elbos = trainer.run_chunk(state, config, Xd, Yd, steps)
    jax.block_until_ready(elbos)
    _log(f"[{tag}] warmup chunk (compile + {steps} steps) "
         f"in {time.time() - t0:.1f}s")

    # Timed steady-state chunks; report the best of three.
    steps_per_sec = 0.0
    for _ in range(3):
        t0 = time.time()
        state, elbos = trainer.run_chunk(state, config, Xd, Yd, steps)
        jax.block_until_ready(elbos)
        steps_per_sec = max(steps_per_sec, steps / (time.time() - t0))
    _log(f"[{tag}] final elbo {float(elbos[-1]):.1f}")

    # Efficiency: analytic matmul FLOPs/step -> TFLOP/s -> % of peak,
    # cross-checked against XLA's own cost analysis of the compiled chunk.
    fl = flops_lib.training_step_flops(model, flags.batch_size)
    hw_fl = flops_lib.training_step_hardware_flops(model, flags.batch_size)
    peak = flops_lib.device_peak_flops(jax.devices()[0])
    tflops = fl * steps_per_sec / 1e12
    mfu = 100.0 * tflops * 1e12 / peak
    xla_fl = float('nan')
    try:
        compiled = trainer.run_chunk.lower(
            state, config, Xd, Yd, steps).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        # XLA counts the lax.scan body ONCE (no trip-count multiply), and
        # the chunk is one scan of identical steps — so the program total
        # IS approximately the per-step figure, divided by the scan body's
        # actual unroll factor (per-optimizer; trainer.scan_unroll is the
        # single source of truth).
        unroll = trainer.scan_unroll(config, steps)
        xla_fl = float(ca.get('flops', float('nan'))) / unroll
    except Exception as e:
        _log(f"[{tag}] cost_analysis unavailable: {e}")
    _log(f"[{tag}] {steps_per_sec:.1f} steps/s | analytic "
         f"{fl / 1e9:.2f} model GFLOP/step (inverse-form implementation "
         f"executes {hw_fl / 1e9:.2f}; XLA cost-analysis "
         f"{xla_fl / 1e9:.2f}, scan body counted once) | "
         f"{tflops:.2f} TFLOP/s | "
         f"MFU {mfu:.1f}% of {peak / 1e12:.0f} TFLOP/s "
         f"{flops_lib.MFU_PEAK} peak "
         f"({jax.devices()[0].device_kind})")
    return steps_per_sec, {"gflop_per_step": round(fl / 1e9, 2),
                           "tflops_per_sec": round(tflops, 2),
                           "mfu_pct": round(mfu, 1)}


def _numerics_probe(flags, steps_per_chunk=300, chunks=2):
    """Short Adam run on LEARNABLE blobs (the soak config, tools/soak.py) —
    guards numerics, which the throughput configs cannot: their data is
    unlearnable noise.  Returns (train_accuracy,
    final_elbo).  Keeps its own 300-step chunks (one extra compile,
    served by the persistent cache on reruns) so the documented numerics
    expectations stay pinned while the throughput chunks grow.  Expected:
    accuracy >= 0.90 and ELBO improving after 600 steps (PARITY.md pins
    the measured values)."""
    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.builder import build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.data import learnable_blobs
    from deepcgp_tpu.training.trainer import TrainConfig

    X, Y = learnable_blobs(2048, (32, 32, 3), 10, 0)
    model = build_model(flags, X, Y, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=100000,
                         gamma=0.001, batch_size=flags.batch_size)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(X.reshape(X.shape[0], -1))
    Yd = jnp.asarray(Y)
    elbo0 = None
    for _ in range(chunks):
        state, elbos = trainer.run_chunk(state, config, Xd, Yd,
                                         steps_per_chunk)
        if elbo0 is None:
            elbo0 = float(elbos[0])
    final_elbo = float(elbos[-1])
    acc = trainer.accuracy(state.model, np.asarray(Xd), Y,
                           jax.random.PRNGKey(9), batch_size=128,
                           num_samples=5)
    _log(f"[numerics-probe] {chunks * steps_per_chunk} Adam steps on "
         f"learnable blobs: elbo {elbo0:.1f} -> {final_elbo:.1f}, "
         f"train accuracy {acc:.3f}")
    return acc, final_elbo


def _digits_probe(steps=1000):
    """REAL-data generalization guard: the 2-layer UCI-digits config
    (`deepcgp_tpu/digits.py` — 1,797 genuine handwritten-digit scans
    bundled in scikit-learn's wheel, fixed 80/20 split) trained for 1000
    Adam steps, scored on the held-out 359 scans.  Unlike the synthetic
    blobs probe this measures real-data test accuracy, the quantity the
    reference's own results tables report; expected ~0.99 (PARITY.md
    "Real data: UCI digits" — the full run measured 0.9944 at step 1000,
    0.9916 at convergence).  The loader REFUSES the synthetic fallback for
    'digits' (training/data.py::load_dataset), so a broken sklearn install
    cannot masquerade as real data: this probe returns None (JSON null in
    the driver record) instead of a fake accuracy."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from deepcgp_tpu.models.builder import build_model
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.data import digits_data
    from deepcgp_tpu.training.trainer import TrainConfig

    f = SimpleNamespace(N=1438, test_size=359, seed=0, M='64,64',
                        feature_maps='10', filter_sizes='3,3',
                        strides='1,1', num_samples=10, batch_size=64,
                        base_kernel='rbf', white=False, last_kernel='conv',
                        identity_mean=False)
    try:
        xtr, ytr, xte, yte = digits_data(f)
    except RuntimeError as e:
        _log(f"[digits-probe] SKIPPED — real digits unavailable: {e}")
        return None
    # Belt-and-braces: assert the loader really returned the 1,797-scan
    # UCI set under the fixed 80/20 split, not a stand-in of other shape.
    assert len(xtr) + len(xte) == 1797, \
        f"digits loader returned {len(xtr)}+{len(xte)} rows, not 1797"
    model = build_model(f, xtr, ytr, jax.random.PRNGKey(0),
                        dtype=jnp.float32)
    config = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=7000,
                         gamma=0.001, batch_size=f.batch_size)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    Xd = jnp.asarray(xtr.reshape(len(xtr), -1))
    state, elbos = trainer.run_chunk(state, config, Xd, jnp.asarray(ytr),
                                     steps)
    acc = trainer.accuracy(state.model, xte.reshape(len(xte), -1), yte,
                           jax.random.PRNGKey(9), batch_size=128,
                           num_samples=5)
    _log(f"[digits-probe] {steps} Adam steps on UCI digits (2-layer): "
         f"held-out accuracy {acc:.4f}, final elbo {float(elbos[-1]):.1f}")
    return acc


def main():
    import jax

    from deepcgp_tpu.models.builder import BuilderFlags

    rng = np.random.RandomState(0)
    flags = BuilderFlags(M='384,384', feature_maps='10', filter_sizes='5,5',
                         strides='3,1', num_samples=10, batch_size=32)
    # Synthetic CIFAR-shaped data (bench measures compute, not accuracy).
    N = 2048
    X = rng.randn(N, 32, 32, 3).astype(np.float32)
    Y = rng.randint(0, 10, size=(N, 1))

    _log(f"devices: {jax.devices()}")
    steps_per_sec, mfu = _bench_config('flagship-adam', flags, 'Adam', X, Y)
    result = {
        "metric": "cifar10_2layer_convgp_steps_per_sec",
        "value": round(steps_per_sec, 3),
        "unit": "optimizer steps/sec (batch 32, S=10, M=384,384)",
        "vs_baseline": round(steps_per_sec / BASELINE_STEPS_PER_SEC, 2),
        "mfu_pct": mfu["mfu_pct"],
        "gflop_per_step": mfu["gflop_per_step"],
    }

    if not os.environ.get('DEEPCGP_BENCH_FAST'):
        # Secondary headline configs ride the same stdout JSON line so the
        # driver records all three every round.
        ng_sps, ng_mfu = _bench_config('flagship-natgrad', flags, 'NatGrad',
                                       X, Y)
        result.update(natgrad_steps_per_sec=round(ng_sps, 3),
                      natgrad_vs_baseline=round(
                          ng_sps / BASELINE_STEPS_PER_SEC, 2),
                      natgrad_mfu_pct=ng_mfu["mfu_pct"])
        mflags = BuilderFlags(M='1024', feature_maps='', filter_sizes='5',
                              strides='1', num_samples=10, batch_size=128,
                              last_kernel='rbf')
        Xm = rng.randn(2048, 28, 28, 1).astype(np.float32)
        Ym = rng.randint(0, 10, size=(2048, 1))
        m_sps, m_mfu = _bench_config('mnist-m1024', mflags, 'Adam', Xm, Ym)
        result.update(m1024_steps_per_sec=round(m_sps, 3),
                      m1024_mfu_pct=m_mfu["mfu_pct"])
        # NatGrad at M=1024: the regime the reference's headline MNIST runs
        # use NatGrad for (`conv_gp/experiment.py:90-108`, 10x[1024,1024]
        # variational stacks) — exercises the [1024, 1024] factorization,
        # SR-bf16 moments and the NatGrad update in one program.
        mn_sps, mn_mfu = _bench_config('mnist-m1024-natgrad', mflags,
                                       'NatGrad', Xm, Ym)
        result.update(m1024_natgrad_steps_per_sec=round(mn_sps, 3),
                      m1024_natgrad_mfu_pct=mn_mfu["mfu_pct"])
        # Numerics guard: short learnable-data run so a precision/numerics
        # regression shows up in the benchmark record.
        acc, probe_elbo = _numerics_probe(flags)
        result.update(probe_train_accuracy=round(acc, 4),
                      probe_final_elbo=round(probe_elbo, 1))
        # Real-data guard: held-out accuracy on genuine handwritten digits
        # (the one real image dataset available offline).
        # None (JSON null) when real digits are unavailable — never a
        # synthetic-data number under a real-data label.
        digits_acc = _digits_probe()
        result.update(digits_test_accuracy=(
            None if digits_acc is None else round(digits_acc, 4)))

    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
