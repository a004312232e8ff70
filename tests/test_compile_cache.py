"""Placement of the persistent compilation cache (``deepcgp_tpu/__init__``):
``$JAX_COMPILATION_CACHE_DIR`` when set, else a fixed directory inside the
checkout."""

import os
import subprocess
import sys

import jax

import deepcgp_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_fixed_directory_in_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert deepcgp_tpu.compilation_cache_dir() == os.path.join(
        REPO, '.jax_cache')
    assert deepcgp_tpu.DEFAULT_COMPILATION_CACHE_DIR == os.path.join(
        REPO, '.jax_cache')


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert deepcgp_tpu.compilation_cache_dir() == str(tmp_path)


def test_package_configures_jax(tmp_path):
    """In a fresh process: unset, the package points JAX at the checkout's
    directory; set, JAX keeps the variable's directory."""
    code = ('import jax, deepcgp_tpu; '
            'print(jax.config.jax_compilation_cache_dir)')
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env['JAX_PLATFORMS'] = 'cpu'
    unset = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                           capture_output=True, text=True, check=True)
    assert unset.stdout.strip() == os.path.join(REPO, '.jax_cache')
    env['JAX_COMPILATION_CACHE_DIR'] = str(tmp_path)
    set_ = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                          capture_output=True, text=True, check=True)
    assert set_.stdout.strip() == str(tmp_path)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
