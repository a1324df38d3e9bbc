"""Frozen dataclasses that are JAX pytrees.

`dataclass` turns a class into a frozen `dataclasses.dataclass` registered
with `jax.tree_util.register_dataclass`: every field is a pytree child
unless it was declared with `field(pytree_node=False)`, which makes it
static metadata (part of the treedef, hashed into jit cache keys).
Instances get `.replace(**changes)`, a `dataclasses.replace` shorthand.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(pytree_node: bool = True, **kwargs):
    """`dataclasses.field` with a `pytree_node` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    static = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=static)
    cls.replace = dataclasses.replace
    return cls
