"""Immutable pytree dataclasses.

``@dataclass`` makes a frozen dataclass and registers it as a JAX pytree:
fields declared with ``field(pytree_node=False)`` are static metadata (part
of the tree structure, so a change retraces a jitted function), every other
field is a child leaf or subtree.  Instances get ``.replace(**updates)``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag in its metadata."""
    metadata = dict(kwargs.pop('metadata', None) or {})
    metadata['pytree_node'] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    """A copy with the named fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass registered with ``jax.tree_util``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get('pytree_node', True) else meta).append(f.name)
    cls.replace = _replace
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls
