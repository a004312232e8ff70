"""Analytic FLOP accounting sanity (utils/flops.py, SURVEY.md §7.9)."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.models.builder import BuilderFlags, build_model
from deepcgp_tpu.utils import flops as flops_lib


def _model(num_samples=2, M='8,8'):
    rng = np.random.RandomState(0)
    flags = BuilderFlags(M=M, feature_maps='2', filter_sizes='5,3',
                         strides='2,1', num_samples=num_samples,
                         batch_size=8)
    X = rng.randn(32, 12, 12, 1)
    Y = rng.randint(0, 10, size=(32, 1))
    return build_model(flags, X, Y, jax.random.PRNGKey(0),
                       dtype=jnp.float64)


def test_training_step_flops_basic():
    model = _model()
    fl = flops_lib.training_step_flops(model, 8)
    assert fl > 0
    # Doubling the batch must increase the per-eval work but less than 2x
    # overall (the once-per-step Kuu/chol/KL terms are batch-independent).
    fl2 = flops_lib.training_step_flops(model, 16)
    assert fl < fl2 < 2 * fl


def test_training_step_flops_sample_sharing():
    """Layer 1 is S-shared (models/dgp.py), so S only scales the later
    layers: going S=2 -> S=4 must grow FLOPs by strictly less than 2x."""
    fl_s2 = flops_lib.training_step_flops(_model(num_samples=2), 8)
    fl_s4 = flops_lib.training_step_flops(_model(num_samples=4), 8)
    assert fl_s2 < fl_s4 < 2 * fl_s2


@pytest.mark.slow
def test_flops_order_of_magnitude_vs_xla():
    """The analytic *hardware* count (what the inverse-form implementation
    executes) must agree with XLA's cost analysis of the real
    forward+backward program within a loose factor (the analytic number
    counts matmul work only; XLA counts everything)."""
    from deepcgp_tpu.training import trainer
    from deepcgp_tpu.training.trainer import TrainConfig

    model = _model()
    config = TrainConfig(optimizer='Adam', batch_size=8)
    state = trainer.init_state(model, config, jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    X = jnp.asarray(rng.randn(32, 144))
    Y = jnp.asarray(rng.randint(0, 10, size=(32, 1)))
    steps = 2
    try:
        compiled = trainer.run_chunk.lower(state, config, X, Y,
                                           steps).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        # XLA counts the scan body once (no trip-count multiply), so the
        # program total approximates ONE step regardless of `steps`.
        xla = float(ca['flops'])
    except (KeyError, TypeError, Exception) as e:  # pragma: no cover
        import pytest
        pytest.skip(f"cost_analysis unavailable on this backend: {e}")
    analytic = flops_lib.training_step_hardware_flops(model, 8)
    assert 0.1 < analytic / xla < 10.0, (analytic, xla)
    # The model-FLOPs figure (MFU numerator) must stay at or below the
    # hardware figure: extra implementation arithmetic never earns MFU.
    assert flops_lib.training_step_flops(model, 8) <= analytic


@pytest.mark.parametrize('kind,peak', [
    ('NVIDIA H100 80GB HBM3', 495e12),
    ('NVIDIA H100 PCIe', 495e12),
    ('NVIDIA H100 NVL', 495e12),
    ('cpu', None),
    ('NVIDIA A100-SXM4-80GB', None),
])
def test_device_peak_lookup(kind, peak):
    """H100 kinds resolve to the TF32 peak MFU is quoted against; a device
    missing from the table raises instead of returning a default."""
    class Dev:
        device_kind = kind
    if peak is None:
        with pytest.raises(ValueError, match='no peak rates'):
            flops_lib.device_peak_flops(Dev())
    else:
        assert flops_lib.MFU_PEAK == 'tf32'
        assert flops_lib.device_peak_flops(Dev()) == peak
        assert flops_lib.device_peaks(Dev())['hbm_bytes_per_s'] == 3.35e12
