"""Immutable dataclass pytrees for train states."""

from __future__ import annotations

import dataclasses

import jax


class PyTreeNode:
    """Base class: subclasses become frozen dataclasses registered as pytrees
    (every field is a pytree child); ``replace`` returns an updated copy."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        dataclasses.dataclass(frozen=True)(cls)
        jax.tree_util.register_dataclass(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
