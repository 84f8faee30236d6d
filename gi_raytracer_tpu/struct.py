"""Frozen dataclasses that are JAX pytrees.

Array fields are pytree children (traced, differentiated, sharded); fields
declared with :func:`static_field` are part of the tree structure (Python
values that select code paths, such as grid dimensions or capability
flags).  Instances are immutable; ``obj.replace(field=value)`` returns an
updated copy.
"""

from __future__ import annotations

import dataclasses

import jax

_STATIC = "pytree_static"


def static_field(**kw):
    """A dataclass field carried in the pytree structure, not as a leaf."""
    return dataclasses.field(metadata={_STATIC: True}, **kw)


def _replace(self, **kw):
    return dataclasses.replace(self, **kw)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if not f.metadata.get(_STATIC, False)]
    meta = [f.name for f in fields if f.metadata.get(_STATIC, False)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
