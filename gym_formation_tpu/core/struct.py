"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass whose fields are pytree
children, except those declared with ``struct.field(pytree_node=False)``,
which are static metadata.  ``.replace(**changes)`` returns a copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
