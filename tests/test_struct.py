"""utils/struct.py: the package's frozen pytree dataclasses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clpathtracer_tpu.utils import struct


@struct.dataclass
class Box:
    lo: jnp.ndarray
    hi: jnp.ndarray = None
    res: tuple = struct.field(pytree_node=False, default=(1, 1, 1))


def test_flatten_unflatten_roundtrip():
    b = Box(lo=jnp.zeros(3), hi=jnp.ones(3), res=(2, 3, 4))
    leaves, treedef = jax.tree.flatten(b)
    assert len(leaves) == 2  # static res is not a leaf
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, Box) and back.res == (2, 3, 4)
    np.testing.assert_array_equal(np.asarray(back.hi), np.ones(3))


def test_none_field_is_an_empty_subtree():
    b = Box(lo=jnp.zeros(3))
    assert len(jax.tree.leaves(b)) == 1
    doubled = jax.tree.map(lambda x: 2 * x, Box(lo=jnp.ones(2)))
    assert doubled.hi is None
    np.testing.assert_array_equal(np.asarray(doubled.lo), [2.0, 2.0])


def test_static_field_is_part_of_the_jit_cache_key():
    traces = []

    @jax.jit
    def f(b):
        traces.append(b.res)
        return b.lo * sum(b.res)

    np.testing.assert_array_equal(np.asarray(f(Box(jnp.ones(2), res=(1,)))),
                                  [1.0, 1.0])
    np.testing.assert_array_equal(
        np.asarray(f(Box(jnp.ones(2), res=(1, 2)))), [3.0, 3.0])
    f(Box(jnp.ones(2) * 5.0, res=(1,)))  # same static value: cached
    assert traces == [(1,), (1, 2)]


def test_replace_and_frozen():
    b = Box(lo=jnp.zeros(3), res=(4, 4, 4))
    c = b.replace(hi=jnp.ones(3))
    assert b.hi is None and c.res == (4, 4, 4)
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.lo = jnp.ones(3)
    with pytest.raises(TypeError):
        b.replace(nope=1)


def test_grad_through_fields():
    g = jax.grad(lambda b: jnp.sum(b.lo * b.hi))(
        Box(lo=jnp.arange(3.0), hi=jnp.full(3, 2.0)))
    np.testing.assert_array_equal(np.asarray(g.lo), [2.0, 2.0, 2.0])
    np.testing.assert_array_equal(np.asarray(g.hi), [0.0, 1.0, 2.0])


def _instances():
    from clpathtracer_tpu.accel.grid import build_grid
    from clpathtracer_tpu.accel.sah import build_kd_tree
    from clpathtracer_tpu.core.camera import Camera
    from clpathtracer_tpu.core.ray import RayBatch
    from clpathtracer_tpu.ops.traverse import PackedTris
    from clpathtracer_tpu.parallel.treelet import build_sharded_tree
    from clpathtracer_tpu.scene.procedural import cornell_box

    scene = cornell_box()
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    tree = build_kd_tree(tv, tri_block=4)
    return {
        "Scene": scene,
        "Camera": Camera.create(position=[0, 0, -1.0], forward=[0, 0, 1.0]),
        "FlatKdTree": tree,
        "UniformGrid": build_grid(tv, res=(3, 3, 3)),
        "ShardedTree": build_sharded_tree(tv, n_shards=2),
        "RayBatch": RayBatch.create(jnp.zeros((4, 3)), jnp.ones((4, 3))),
        "PackedTris": PackedTris.pack(tree, v0, v1, v2),
    }


@pytest.mark.parametrize("name", ["Scene", "Camera", "FlatKdTree",
                                  "UniformGrid", "ShardedTree", "RayBatch",
                                  "PackedTris"])
def test_package_containers_are_pytrees(name):
    obj = _instances()[name]
    assert type(obj).__name__ == name
    leaves, treedef = jax.tree.flatten(obj)
    assert leaves and all(hasattr(x, "shape") for x in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert jax.tree.structure(back) == treedef
    # through jit and back unchanged
    same = jax.jit(lambda x: x)(obj)
    for a, b in zip(jax.tree.leaves(same), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(obj.replace()) is type(obj)


def test_nested_tree_side_structures_flatten():
    from clpathtracer_tpu.accel.sah import attach_grid, attach_shadow_tree
    inst = _instances()
    tree = inst["FlatKdTree"]
    tv = np.asarray(inst["Scene"].verts)[np.asarray(
        inst["Scene"].faces)[:, :, 0]]
    both = attach_shadow_tree(attach_grid(tree, tv), tv)
    n_plain = len(jax.tree.leaves(tree))
    n_both = len(jax.tree.leaves(both))
    assert n_both == (n_plain + len(jax.tree.leaves(both.grid))
                      + len(jax.tree.leaves(both.shadow)))
    assert jax.tree.structure(both.grid).num_leaves > 0
