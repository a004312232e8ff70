"""Multi-host input pipeline (SURVEY.md §2.10 / §5.8: "multi-host DCN data
loading" is new design — the reference is single-process).

Pattern: each host loads only its shard of the training set
(:func:`process_shard`), and per-host batches are assembled into one global
device array across the mesh with
:func:`host_local_to_global` (``jax.make_array_from_process_local_data``) —
batch rows ride host->device PCIe once, never cross-host; gradient psums run
over the device interconnect inside the jitted step.

Single-host (including this repo's CI and the one-chip bench) it all
degenerates to identity slicing, so the same experiment code runs anywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize_distributed(**kw) -> None:
    """``jax.distributed.initialize`` with env-based defaults; idempotent.

    Only the already-initialised error is swallowed — a genuine setup
    failure (bad/unreachable coordinator) must propagate, otherwise every
    host silently trains its own single-process model on a data shard."""
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:
        msg = str(e).lower()
        # jax 0.9 phrases this 'distributed.initialize should only be
        # called once.'; older versions said 'already initialized'.
        if 'only be called once' not in msg and 'already' not in msg:
            raise


def process_shard(array: np.ndarray, *, axis: int = 0) -> np.ndarray:
    """This host's contiguous slice of a host-loaded array, row-sharded
    across processes as an EVEN split: every process contributes the same
    shard shape, which ``jax.make_array_from_process_local_data`` requires
    for assembly.  The remainder (at most process_count-1 trailing rows) is
    dropped — standard data-parallel practice for the *training* set; for
    evaluation sets, where every row must count, pad first with
    :func:`pad_rows` (sentinel labels keep padded rows out of the accuracy
    numerator)."""
    n_proc = jax.process_count()
    idx = jax.process_index()
    per = array.shape[axis] // n_proc
    start = idx * per
    return array.take(np.arange(start, start + per), axis=axis)


def pad_rows(X: np.ndarray, Y: np.ndarray, multiple: int):
    """Pad (X, Y) along axis 0 to the next multiple of ``multiple`` with
    zero rows and sentinel labels (-1).  Class predictions (argmax over
    [0, K)) can never equal -1, so padded rows contribute nothing to a
    correct-prediction count; callers divide by the TRUE row count."""
    n = X.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return np.asarray(X), np.asarray(Y)
    Xp = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)])
    Yp = np.concatenate([Y, np.full((pad,) + Y.shape[1:], -1, Y.dtype)])
    return Xp, Yp


def host_local_to_global(mesh, *arrays, axis_name: str = 'data'):
    """Assemble per-host batch shards into global jax.Arrays sharded over
    ``axis_name`` (each host contributes its local rows)."""
    sharding = NamedSharding(mesh, P(axis_name))
    out = tuple(
        jax.make_array_from_process_local_data(sharding, np.asarray(a))
        for a in arrays)
    return out if len(out) > 1 else out[0]
