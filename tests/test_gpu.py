"""Numerics that only the card can show: what each matmul precision does to
a float32 product, and the linear algebra of the conditional and NatGrad at
benchmark widths, against float64 numpy.  Marked ``gpu``; each test skips
from its fixture when JAX has no GPU (see conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from deepcgp_tpu.ops import linalg
from deepcgp_tpu.training import optim

pytestmark = pytest.mark.gpu


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _spd(rng, B, M):
    A = rng.randn(B, M, M)
    return A @ np.swapaxes(A, -1, -2) / M + 0.5 * np.eye(M)


def test_highest_matmul_is_float32_accurate(gpu_device):
    """The inverse-apply and NatGrad-state products run at HIGHEST, which
    must keep float32 accuracy on the card (DEFAULT and HIGH may be TF32)."""
    rng = np.random.RandomState(0)
    a = rng.randn(384, 384).astype(np.float32)
    b = rng.randn(384, 3200).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = jax.jit(lambda x, y: jnp.matmul(x, y,
                                          precision=lax.Precision.HIGHEST))(
        jax.device_put(a, gpu_device), jax.device_put(b, gpu_device))
    assert _rel(got, want) < 1e-6
    assert linalg._INV_PRECISION == lax.Precision.HIGHEST
    assert optim._STATE_PRECISION == lax.Precision.HIGHEST


def test_chol_with_inv_on_card(gpu_device):
    """The flagship Kuu stack [3, 384, 384]: factor and inverse in float32
    on the card against float64 numpy."""
    rng = np.random.RandomState(1)
    S = _spd(rng, 3, 384)
    L, Linv = jax.jit(linalg.chol_with_inv)(
        jax.device_put(S.astype(np.float32), gpu_device))
    ref = np.linalg.cholesky(S)
    assert _rel(L, ref) < 1e-5
    assert _rel(Linv, np.linalg.inv(ref)) < 1e-4


def test_natgrad_update_on_card(gpu_device):
    """The fused NatGrad update on the flagship [20, 384, 384] stack agrees
    with the explicit theta round trip in float64."""
    rng = np.random.RandomState(2)
    R, M = 20, 384
    q_sqrt = np.linalg.cholesky(_spd(rng, R, M))
    q_mu = rng.randn(M, R)
    dq_mu = rng.randn(M, R)
    dq_sqrt = rng.randn(R, M, M)
    gamma = 1e-3
    with jax.default_device(jax.devices('cpu')[0]):
        mu64, W64 = optim.natgrad_update_theta(q_mu, q_sqrt, dq_mu, dq_sqrt,
                                               gamma)
    args = [jax.device_put(np.asarray(x, np.float32), gpu_device)
            for x in (q_mu, q_sqrt, dq_mu, dq_sqrt)]
    mu, W = jax.jit(optim.natgrad_update)(*args, np.float32(gamma))
    assert _rel(W, W64) < 1e-4
    assert _rel(mu, mu64) < 1e-4
