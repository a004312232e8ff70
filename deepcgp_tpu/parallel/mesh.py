"""Device mesh construction and sharding specs.

The reference is strictly single-process/single-device (SURVEY.md §2.10), so
all of this is new design:

* ``data`` axis — the image batch (and with it the MC-sample work) is
  sharded across devices; the SPMD partitioner inserts the gradient psum
  automatically when the jitted train step consumes data-sharded inputs.
* ``model`` axis — the patch axis P (this workload's sequence axis,
  SURVEY.md §5.7) and the per-position GP axis R are sharded via
  ``with_sharding_constraint`` inside the layers (see
  deepcgp_tpu.parallel.sharding), partitioning the dominant Kuf / q_sqrt-term
  einsums; the inducing dimension M stays replicated (Kuu Cholesky is tiny
  relative to the patch work and replicating it avoids per-step collectives
  on the solve path).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def parse_mesh_spec(spec: str) -> dict:
    """'data=4,model=2' -> {'data': 4, 'model': 2}."""
    out = {}
    if not spec:
        return out
    for part in spec.split(','):
        name, size = part.split('=')
        out[name.strip()] = int(size)
    return out


def make_mesh(spec: str | dict | None = None, devices=None) -> Mesh:
    """Build a Mesh with axes ('data', 'model').  With no spec, all devices
    go to 'data'."""
    if devices is None:
        devices = jax.devices()
    if isinstance(spec, str):
        spec = parse_mesh_spec(spec)
    if not spec:
        spec = {'data': len(devices)}
    unknown = set(spec) - {'data', 'model'}
    assert not unknown, f"unknown mesh axes {unknown}; valid: data, model"
    n_data = spec.get('data', 1)
    n_model = spec.get('model', 1)
    assert n_data * n_model <= len(devices), \
        f"mesh {spec} needs {n_data * n_model} devices, have {len(devices)}"
    devs = np.asarray(devices[:n_data * n_model]).reshape(n_data, n_model)
    return Mesh(devs, ('data', 'model'))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Rows of [N, ...] arrays across the data axis."""
    return NamedSharding(mesh, P('data'))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    s = batch_sharding(mesh)
    out = tuple(jax.device_put(a, s) for a in arrays)
    return out if len(out) > 1 else out[0]
