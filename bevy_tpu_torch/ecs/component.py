"""Component definition & registry (port of bevy_tpu/ecs/component.py).

A component is a named struct of fixed-shape fields, stored structure-of-
arrays: each field is one `(capacity, *shape)` tensor in the world state
dict. Storage names are the snake-case class names, the same keys the JAX
package uses, so a JAX world's state maps onto this one key for key
(see bevy_tpu_torch/interop.py).

Usage::

    @component
    class Velocity:
        value = field(2)                 # (2,) f32, zeros default
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.bool: np.bool_}


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def np_dtype(dtype):
    """numpy dtype of a field's torch dtype (float32, int32 or bool)."""
    return _NP_DTYPES[dtype]


@dataclass(frozen=True)
class Field:
    shape: Tuple[int, ...]
    dtype: Any
    default: Any


def field(shape=(), dtype=torch.float32, default=None):
    """Declare a component field. `shape` is the per-entity trailing shape
    (scalar = ()); `default` fills unspecified values at spawn."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if default is None:
        default = np.zeros(shape, np_dtype(dtype))
    return Field(shape=shape, dtype=dtype, default=default)


class ComponentSpec:
    """Registered metadata for one component type (ref: ComponentInfo)."""

    def __init__(self, cls, name: str, fields: Dict[str, Field]):
        self.cls = cls
        self.name = name
        self.fields = fields

    def __repr__(self):
        return f"ComponentSpec({self.name}, fields={list(self.fields)})"


_REGISTRY: Dict[type, ComponentSpec] = {}


def get_spec(comp) -> ComponentSpec:
    if isinstance(comp, ComponentSpec):
        return comp
    if isinstance(comp, ComponentInstance):
        return comp.spec
    spec = _REGISTRY.get(comp)
    if spec is None:
        raise TypeError(f"{comp!r} is not a registered component (use @component)")
    return spec


class ComponentInstance:
    """A spawnable value: spec + per-field values (host-side)."""

    __slots__ = ("spec", "values")

    def __init__(self, spec: ComponentSpec, values: Dict[str, Any]):
        self.spec = spec
        self.values = values

    def __repr__(self):
        return f"{self.spec.name}({self.values})"


def component(cls=None, *, name: Optional[str] = None):
    """Class decorator registering a component type. Calling the class
    returns a `ComponentInstance`; the class itself is the query handle."""

    def wrap(cls):
        fields = {k: v for k, v in vars(cls).items() if isinstance(v, Field)}
        spec = ComponentSpec(cls, name or _snake(cls.__name__), fields)
        _REGISTRY[cls] = spec

        def __new__(klass, **kwargs):
            unknown = set(kwargs) - set(fields)
            if unknown:
                raise TypeError(f"{spec.name}: unknown fields {unknown}")
            return ComponentInstance(spec, kwargs)

        cls.__new__ = staticmethod(__new__)
        cls.__component_spec__ = spec
        return cls

    if cls is not None:
        return wrap(cls)
    return wrap


def resource(cls=None, *, name: Optional[str] = None):
    """Like @component but for singleton resources, stored as named dicts
    of 0-d (or fixed-shape) tensors in `state['res']`."""
    return component(cls, name=name) if cls is not None else component(name=name)
