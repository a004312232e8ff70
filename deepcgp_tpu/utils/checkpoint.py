"""Checkpoint save / resume.

Rebuild of the reference's parameter snapshot scheme:

* save: flat dict {pathname: constrained numpy value} + global_step written
  with ``np.save`` after every train epoch (`conv_gp/experiment.py:56-64`);
* load: pathname parsing into per-layer dicts, shallower-to-deeper depth
  remap (grow a deeper net from a shallow checkpoint), filter-size-mismatch
  reset (`conv_gp/models.py:200-247`, SURVEY.md §3.5).

Pathnames follow the reference's ``DGP/layers/<i>/<param>`` layout so the
loader's substring matching (`conv_gp/models.py:214-228`) applies unchanged.
"""

from __future__ import annotations

import os
import re

import numpy as np

from deepcgp_tpu.models.base_kernels import ArcCosine, RBF
from deepcgp_tpu.models.layers import ConvLayer


def model_parameters(model, global_step: int) -> dict:
    """Flat {pathname: constrained value} dict (+ global_step).

    Note on the KL prior anchor: Z0 is intentionally NOT saved.  The
    reference snapshots its KL prior Kuu from the CURRENT Z at model
    construction (`conv_gp/layers.py:149-152`), so a --load-model restart
    re-anchors the prior at the loaded Z — this snapshot format reproduces
    exactly that; the orbax full-state path preserves Z0 (and thus the
    uninterrupted trajectory) instead."""
    params = {}
    for i, layer in enumerate(model.layers):
        prefix = f'DGP/layers/{i}/'
        params[prefix + 'q_mu'] = np.asarray(layer.q_mu)
        params[prefix + 'q_sqrt'] = np.tril(np.asarray(layer.q_sqrt))
        params[prefix + 'feature/Z'] = np.asarray(layer.Z)
        if isinstance(layer, ConvLayer):
            base = layer.base_kernel
            kern_prefix = prefix + 'kern/base_kernel/'
        else:
            kern = layer.kernel
            base = getattr(kern, 'base_kernel', None)
            if base is None:
                # Plain base kernel (rbf last layer): gpflow pathnames have
                # no 'base_kernel/' segment (`conv_gp/models.py:162-168`
                # builds a bare gpflow.kernels.RBF, so its params save as
                # 'kern/variance' / 'kern/lengthscales').
                base = kern
                kern_prefix = prefix + 'kern/'
            else:
                kern_prefix = prefix + 'kern/base_kernel/'
            pw = getattr(kern, 'patch_weights', None)
            if pw is not None:
                params[prefix + 'kern/patch_weights'] = np.asarray(pw)
        if isinstance(base, RBF):
            params[kern_prefix + 'variance'] = np.asarray(base.variance)
            params[kern_prefix + 'lengthscales'] = \
                np.asarray(base.lengthscales)
        elif isinstance(base, ArcCosine):
            params[kern_prefix + 'variance'] = np.asarray(base.variance)
            params[kern_prefix + 'weight_variances'] = \
                np.asarray(base.weight_variances)
            params[kern_prefix + 'bias_variance'] = \
                np.asarray(base.bias_variance)
    params['global_step'] = int(global_step)
    return params


def save_model(path: str, model, global_step: int) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.save(path, np.asarray(model_parameters(model, global_step),
                             dtype=object))


def load_raw(path: str) -> dict:
    return np.load(path, allow_pickle=True).item()


def parse_layer_parameters(parameters: dict, model_layers: int):
    """`conv_gp/models.py:200-240`: pathnames -> per-layer dicts + depth
    remap.  Returns (global_step, {layer_index: params})."""
    parameters = dict(parameters)
    global_step = int(parameters.pop('global_step', 0))
    layer_params = {}

    for key, value in parameters.items():
        if 'layers' not in key:
            continue
        parts = key.split('/')
        layer = int(parts[2])
        path = '/'.join(parts[3:])
        values = layer_params.setdefault(layer, {})
        # Priority matching mirrors `conv_gp/models.py:216-228`.
        if 'q_mu' in path:
            values['q_mu'] = value
        elif 'q_sqrt' in path:
            values['q_sqrt'] = value
        elif 'Z' in path:
            values['Z'] = value
        elif 'base_kernel/weight_variances' in path:
            values['base_kernel/weight_variances'] = value
        elif 'base_kernel/bias_variance' in path:
            values['base_kernel/bias_variance'] = value
        elif 'base_kernel/variance' in path:
            values['base_kernel/variance'] = value
        elif 'base_kernel/lengthscales' in path:
            values['base_kernel/lengthscales'] = value
        elif 'patch_weights' in path:
            values['patch_weights'] = value
        # Un-prefixed pathnames of a plain (non-patch) last-layer kernel —
        # gpflow saves a bare RBF's params as 'kern/{variance,lengthscales}'
        # and the reference's rbf branch reads exactly these keys
        # (`conv_gp/models.py:162-164`).  Ordered last so the prefixed
        # matches above win; 'lengthscales' before 'variance' is irrelevant
        # (disjoint), but both must follow 'weight_variances'/'bias_variance'.
        elif 'lengthscales' in path:
            values['lengthscales'] = value
        # Bare-ArcCosine keys must not fall through to the bare 'variance'
        # branch below ('variance' is a substring of both) — that would
        # last-write-wins corrupt values['variance'] and silently drop the
        # ArcCosine hyperparameters.
        elif 'weight_variances' in path:
            values['weight_variances'] = value
        elif 'bias_variance' in path:
            values['bias_variance'] = value
        elif 'variance' in path:
            values['variance'] = value

    stored_layers = max(layer_params.keys()) + 1
    assert stored_layers <= model_layers, \
        "Can't load a deeper checkpoint into a shallower model"
    if stored_layers != model_layers:
        # Move the stored last layer into the new last slot
        # (`conv_gp/models.py:231-238`).
        last = layer_params.pop(stored_layers - 1)
        layer_params[model_layers - 1] = last
    return global_step, layer_params


def load_layer_parameters(path: str, model_layers: int):
    return parse_layer_parameters(load_raw(path), model_layers)


# ------------------------------------------------------------- full state
# The reference's .npy snapshot drops optimizer state (Adam moments are NOT
# saved — SURVEY.md §5.4), so resume restarts the moments from zero.  For
# preemption tolerance this build adds an orbax-backed checkpoint of the
# ENTIRE TrainState (model + optimizer moments + step + PRNG key + NatGrad
# backoff counter) alongside the reference-compatible snapshot.

def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "full-state checkpoints (--full-state-ckpt) need the "
            "orbax-checkpoint package, which is not installed") from e
    return ocp


def save_train_state(directory: str, state, *, keep: int = 3) -> None:
    """Write the full TrainState under ``directory/state_<step>``."""
    ocp = _orbax()
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    step = int(state.step)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.join(directory, f'state_{step}'), state,
                   force=True)
    # Prune old snapshots (cheapest possible retention policy).  In a
    # multi-process run every process calls save (it is an orbax
    # collective), but only process 0 may touch the files.
    import jax
    if jax.process_index() == 0:
        snaps = sorted(_complete_snapshots(directory), key=_snap_step)
        for old in snaps[:-keep]:
            import shutil
            shutil.rmtree(os.path.join(directory, old), ignore_errors=True)


_SNAP_RE = re.compile(r'^state_(\d+)$')


def _snap_step(name: str) -> int:
    return int(_SNAP_RE.match(name).group(1))


def _complete_snapshots(directory: str) -> list:
    """Only fully-written snapshots: orbax saves into
    'state_<n>.orbax-checkpoint-tmp-*' and renames on completion, so a crash
    mid-save leaves tmp dirs that must not break resume."""
    return [d for d in os.listdir(directory) if _SNAP_RE.match(d)]


def latest_train_state_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [_snap_step(d) for d in _complete_snapshots(directory)]
    return max(steps) if steps else None


def restore_train_state(directory: str, abstract_state):
    """Restore the newest full TrainState; ``abstract_state`` is a template
    with the right structure/shapes/dtypes (e.g. a freshly built state).

    Migrations:

    * snapshots written before ``TrainState.prev_model`` existed (the
      NatGrad deferred-verification rollback target) have no 'prev_model'
      subtree.  Restoring against a template WITHOUT it and seeding
      prev_model from the restored model preserves resumability of old
      checkpoints — the restored parameters were loss-verified when saved,
      which is exactly what prev_model asserts.
    * optimizer-moment STORAGE DTYPE changes (DEEPCGP_ADAM_MOMENT_DTYPE /
      the per-leaf 'auto' SR-bf16 default, training/trainer.py::_adam_core):
      every leaf restores with an explicit cast to the template's dtype
      (orbax RestoreArgs(dtype=...)), so an f32-moment snapshot resumes
      into a bf16-storage run and vice versa instead of failing on the
      dtype mismatch.  The f32->bf16 direction is a one-time
      round-to-nearest of the restored value — subsequent stores go
      through the optimizer's own stochastic rounding — and bf16->f32 is
      exact.  Shape/structure mismatches still propagate unmasked."""
    import jax
    ocp = _orbax()

    def construct_restore_args(tpl):
        # NUMPY restore with an explicit cast to each template leaf's dtype.
        # NOT checkpoint_utils.construct_restore_args: that pins every
        # restored array to the TEMPLATE's sharding (a committed
        # single-device placement for a freshly built state), and committed
        # arrays then refuse to feed the pjit'd multi-process chunk
        # ("incompatible devices"; caught by the two-process resume e2e).
        # Host arrays stay uncommitted, so the sharded and single-device
        # paths both accept them, exactly like freshly initialized state.
        def one(t):
            dt = getattr(t, 'dtype', None)
            if dt is None:
                return ocp.RestoreArgs()
            return ocp.RestoreArgs(restore_type=np.ndarray, dtype=dt)
        return jax.tree_util.tree_map(one, tpl)

    directory = os.path.abspath(directory)
    step = latest_train_state_step(directory)
    if step is None:
        raise FileNotFoundError(f"no state_* checkpoints under {directory}")
    path = os.path.join(directory, f'state_{step}')
    with ocp.PyTreeCheckpointer() as ckptr:
        if not _snapshot_has_key(ckptr, path, 'prev_model'):
            # Explicitly-detected legacy snapshot (written before
            # TrainState.prev_model existed, so the key is absent from the
            # on-disk tree metadata): restore against a dict template
            # WITHOUT the field (orbax rejects any template/disk structure
            # mismatch, even a () placeholder) and seed prev_model from the
            # restored model — those parameters were loss-verified when
            # saved, which is exactly what prev_model asserts.  Any OTHER
            # restore failure (corruption, shape/dtype mismatch) propagates
            # unmasked.
            tpl = {'model': abstract_state.model,
                   'opt_state': abstract_state.opt_state,
                   'step': abstract_state.step,
                   'steps_back': abstract_state.steps_back,
                   'key': abstract_state.key}
            legacy = ckptr.restore(path, tpl,
                                   restore_args=construct_restore_args(tpl))
            prev = legacy['model'] if abstract_state.prev_model != () else ()
            return abstract_state.replace(prev_model=prev, **legacy)
        return ckptr.restore(
            path, abstract_state,
            restore_args=construct_restore_args(abstract_state))


def _snapshot_has_key(ckptr, path: str, key: str) -> bool:
    """True when the on-disk pytree records ``key`` as a top-level field.
    Conservative: if the metadata API is unavailable/unreadable, assume the
    key exists so the normal restore path runs (and genuine errors raise)."""
    try:
        tree = ckptr.metadata(path).item_metadata.tree
        return key in tree
    except Exception:
        return True
