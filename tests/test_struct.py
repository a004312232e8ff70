"""``utils/struct.py``: the immutable pytree dataclasses every model, layer,
kernel and train state is built from."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcgp_tpu.utils import struct


@struct.dataclass
class Pair:
    a: jax.Array
    b: object
    n: int = struct.field(pytree_node=False, default=3)


@struct.dataclass
class Child(Pair):
    c: jax.Array = None


def test_flatten_unflatten_roundtrip():
    p = Pair(a=jnp.ones(2), b={'x': jnp.zeros(3)}, n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                     # a and b['x']; n is static
    q = jax.tree_util.tree_unflatten(treedef, [l + 1 for l in leaves])
    assert isinstance(q, Pair) and q.n == 5
    np.testing.assert_array_equal(q.a, 2 * np.ones(2))
    np.testing.assert_array_equal(q.b['x'], np.ones(3))


def test_static_fields_are_tree_structure():
    p, q = Pair(a=jnp.ones(2), b=1.0, n=1), Pair(a=jnp.ones(2), b=1.0, n=2)
    assert (jax.tree_util.tree_structure(p)
            != jax.tree_util.tree_structure(q))
    assert jax.tree_util.tree_leaves(p)[0].shape == (2,)


def test_replace_and_frozen():
    p = Pair(a=jnp.ones(2), b=1.0)
    q = p.replace(b=2.0)
    assert (p.b, q.b, q.n) == (1.0, 2.0, 3)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.b = 3.0


def test_retrace_on_static_change():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.a * p.n

    p = Pair(a=jnp.ones(2), b=0.0, n=2)
    f(p)
    f(p.replace(a=jnp.zeros(2)))                # same static -> cached
    np.testing.assert_array_equal(f(p.replace(n=4)), 4 * np.ones(2))
    assert traces == [2, 4]


def test_subclass_and_paths():
    """A subclass re-registers with its own fields, and tree paths carry
    attribute names (what optim.trainable_mask matches on)."""
    c = Child(a=jnp.ones(1), b=jnp.ones(1), n=7, c=jnp.ones(1))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(c)[0]]
    assert paths == ['.a', '.b', '.c']
    assert jax.tree_util.tree_map(lambda x: 2 * x, c).n == 7


def test_grad_through_dataclass():
    p = Pair(a=jnp.asarray([1.0, 2.0]), b=jnp.asarray(3.0))
    g = jax.grad(lambda p: jnp.sum(p.a ** 2) * p.b)(p)
    assert isinstance(g, Pair)
    np.testing.assert_allclose(g.a, [6.0, 12.0])
    np.testing.assert_allclose(g.b, 5.0)
