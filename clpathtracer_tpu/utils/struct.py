"""Frozen dataclasses that are JAX pytrees.

The containers of this package (Scene, Camera, FlatKdTree, UniformGrid,
ShardedTree, ...) are frozen dataclasses registered with
`jax.tree_util.register_dataclass`: array fields are pytree leaves and
travel through jit/grad/shard_map; fields declared with
`field(pytree_node=False)` are static metadata that become part of the
treedef, and so of every jit cache key.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    """A copy with the given fields changed (dataclasses.replace)."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Decorator: a frozen dataclass registered as a pytree, with
    `.replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
