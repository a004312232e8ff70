"""``chip_smoke.py`` refuses to run anywhere but on a GPU: its device check
rejects a CPU-only backend, and the script exits non-zero without its
result line."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == 'cpu'
    with pytest.raises(RuntimeError, match='no GPU'):
        chip_smoke.check_device(jax.devices())
    with pytest.raises(RuntimeError, match='no GPU'):
        chip_smoke.check_device([])


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert 'no GPU' in out.stderr
    last = (out.stdout.strip().splitlines() or [''])[-1]
    assert '"ok"' not in last
    with pytest.raises(ValueError):
        json.loads(last)
