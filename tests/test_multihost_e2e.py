"""REAL multi-process (multi-host) integration test on CPU.

Spawns two fresh Python processes that form a 2-process JAX cluster over a
localhost coordinator (2 local CPU devices each -> a global 4-device
'data' mesh) and run one epoch of the MNIST Experiment end-to-end through
the --distributed/--mesh path: per-process row shards assembled by
multihost.host_local_to_global, the pjit'd train chunk, and the sharded
test-accuracy evaluation.  Both processes must finish and report
BIT-IDENTICAL ELBOs (SPMD determinism) — this is the evidence that the
multi-host wiring is more than shard arithmetic.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    proc_id, port = int(sys.argv[1]), sys.argv[2]

    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 2)
    jax.distributed.initialize(
        coordinator_address=f'127.0.0.1:{{port}}',
        num_processes=2, process_id=proc_id)
    assert jax.process_count() == 2
    assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2

    from deepcgp_tpu.mnist import MNIST, read_args
    args = read_args([
        '--name', 'mh_e2e', '-N', '64', '-M', '4,4',
        '--feature-maps', '2', '--filter-sizes', '5,5', '--strides', '2,2',
        '--test-every', '3', '--lr-decay-steps', '4', '--test-size', '16',
        '--num-samples', '2', '--batch-size', '8',
        '--log-dir', sys.argv[3], '--no-tensorboard', '--mesh', 'data=4',
        *sys.argv[4:]])
    exp = MNIST(args)
    try:
        exp.train_step()
        acc = exp.test_accuracy()
        print(f'RESULT p{{proc_id}} step={{exp.global_step}} '
              f'elbo={{exp.last_mean_elbo!r}} acc={{acc!r}}', flush=True)
    finally:
        exp.conclude()
""")


pytestmark = pytest.mark.slow  # full-pipeline matrix / multi-process tests (fast tier skips)

def _launch_pair(tmp_path, worker, log_dirs, extra=(), port_salt=0):
    port = str(20000 + (os.getpid() + port_salt) % 20000)
    env = dict(os.environ)
    # The parent test env forces an 8-device host platform; the workers
    # configure their own device count.
    env.pop('XLA_FLAGS', None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), port, str(log_dirs[i]),
             *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'process {i} failed:\n{out[-3000:]}'
    return outs


def test_two_process_distributed_training(tmp_path):
    worker = tmp_path / 'worker.py'
    worker.write_text(_WORKER.format(repo=REPO))
    outs = _launch_pair(tmp_path, worker,
                        [tmp_path / 'out_0', tmp_path / 'out_1'])

    results = [re.search(r'RESULT p\d+ step=(\d+) elbo=(\S+) acc=(\S+)', o)
               for o in outs]
    assert all(results), [o[-500:] for o in outs]
    steps = {m.group(1) for m in results}
    elbos = {m.group(2) for m in results}
    assert steps == {'3'}
    # SPMD determinism: the replicated ELBO must be bit-identical on both
    # processes (repr equality).
    assert len(elbos) == 1, elbos
    assert 'nan' not in next(iter(elbos)).lower()


def test_two_process_shared_dir_single_writer_and_resume(tmp_path):
    """SHARED --log-dir across both processes (the deployment shape a real
    multi-host run uses): process 0 is the single writer of every artifact
    — one log.csv (one header, one row per epoch), options.toml, the .npy
    snapshot, and the orbax full state — and a SECOND two-process launch
    resumes from that orbax state across both processes and continues
    training."""
    worker = tmp_path / 'worker.py'
    worker.write_text(_WORKER.format(repo=REPO))
    shared = tmp_path / 'shared'

    outs = _launch_pair(tmp_path, worker, [shared, shared],
                        extra=['--full-state-ckpt'], port_salt=17)
    results = [re.search(r'RESULT p\d+ step=(\d+) elbo=(\S+)', o)
               for o in outs]
    assert all(results), [o[-500:] for o in outs]
    assert {m.group(1) for m in results} == {'3'}
    assert len({m.group(2) for m in results}) == 1

    # Single coherent artifact set: exactly one writer touched the files.
    run_dir = shared / 'mh_e2e'
    csv_lines = (run_dir / 'log.csv').read_text().strip().splitlines()
    assert csv_lines[0].startswith('Entry,global_step')
    assert len(csv_lines) == 2, csv_lines  # ONE header + ONE entry
    assert (run_dir / 'options.toml').exists()
    assert (shared / 'mh_e2e.npy').exists()
    state_dir = shared / 'mh_e2e_state'
    assert any(d.startswith('state_3') and 'tmp' not in d
               for d in os.listdir(state_dir)), os.listdir(state_dir)

    # Kill-and-resume: a fresh two-process cluster over the same shared dir
    # restores the orbax state (both processes) and continues to step 6.
    outs2 = _launch_pair(tmp_path, worker, [shared, shared],
                         extra=['--full-state-ckpt'], port_salt=31)
    assert all('resumed full train state at step 3' in o for o in outs2), \
        [o[-800:] for o in outs2]
    results2 = [re.search(r'RESULT p\d+ step=(\d+) elbo=(\S+)', o)
                for o in outs2]
    assert {m.group(1) for m in results2} == {'6'}
    assert len({m.group(2) for m in results2}) == 1
