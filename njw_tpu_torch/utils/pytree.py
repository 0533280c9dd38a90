"""Frozen dataclasses that are also PyTorch pytrees.

Counterpart of ``njw_tpu/utils/pytree.py``. ``pytree_dataclass`` makes a
frozen dataclass, gives it ``.replace(**updates)`` and registers it with
``torch.utils._pytree``: fields marked with ``static_field`` go into the
tree's context, every other field is a child (a tensor, a nested
dataclass or a Python number), so ``tree_flatten`` / ``tree_unflatten``
and ``tree_map`` walk a state as JAX's tree functions walk the
reference's. A field set to ``None`` is no leaf, as in JAX, where
``None`` is an empty subtree.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

from torch.utils import _pytree

T = TypeVar("T")


def static_field(**kwargs):
    """Mark a dataclass field as static (part of the context, not a
    child)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def pytree_dataclass(cls: type[T] | None = None, *, frozen: bool = True):
    """Decorator: a dataclass (frozen by default) registered as a PyTorch
    pytree, with ``.replace(**updates)``."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=frozen)(c)
        fields = dataclasses.fields(c)
        data = [f.name for f in fields if not f.metadata.get("static")]
        meta = [f.name for f in fields if f.metadata.get("static")]

        def flatten(obj):
            present = tuple(n for n in data if getattr(obj, n) is not None)
            return ([getattr(obj, n) for n in present],
                    (present, tuple(getattr(obj, n) for n in meta)))

        def unflatten(children, context):
            present, static = context
            values = dict.fromkeys(data)
            values.update(zip(present, children))
            return c(**values, **dict(zip(meta, static)))

        _pytree.register_pytree_node(
            c, flatten, unflatten,
            serialized_type_name=f"{c.__module__}.{c.__qualname__}")
        c.replace = _replace
        return c

    if cls is None:
        return wrap
    return wrap(cls)
