"""Component definition & registry (port of bevy_tpu/ecs/component.py).

A component is a named struct of fixed-shape fields, stored structure-of-
arrays: each field is one `(capacity, *shape)` tensor in the world state
dict. Storage names are the snake-case class names (module-qualified when
two classes share one), the same keys the JAX package uses, so a JAX
world's state maps onto this one key for key (see
bevy_tpu_torch/interop.py).

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
    entity_ref: bool = False


def field(shape=(), dtype=torch.float32, default=None, entity_ref=False):
    """Declare a component field. `shape` is the per-entity trailing shape
    (scalar = ()); `default` fills unspecified values at spawn;
    `entity_ref` marks a field that holds entity rows."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if default is None:
        default = np.zeros(shape, np_dtype(dtype))
    return Field(shape=shape, dtype=dtype, default=default,
                 entity_ref=entity_ref)


class ComponentSpec:
    """Registered metadata for one component type (ref: ComponentInfo)."""

    def __init__(self, cls, name: str, fields: Dict[str, Field],
                 requires=()):
        self.cls = cls
        self.name = name
        # short attribute alias for query views (q.<attr>): the plain snake
        # name even when `name` was module-qualified (see _claim_name)
        self.attr = _snake(cls.__name__)
        self.fields = fields
        # required components (ref: #[require]): classes or
        # ComponentInstances auto-inserted at spawn / insert when absent
        self.requires = tuple(requires)

    def __repr__(self):
        return f"ComponentSpec({self.name}, fields={list(self.fields)})"


_REGISTRY: Dict[type, ComponentSpec] = {}

# Storage-name ownership: snake name -> owning class. A second, different
# class of the same class name is qualified by its module (and a '#n'
# counter past that), so two components never alias onto one pool.
_NAMES: Dict[str, type] = {}


def _claim_name(cls, base: str) -> str:
    if _NAMES.get(base) in (None, cls):
        _NAMES[base] = cls
        return base
    qual = f"{cls.__module__}.{base}"
    if _NAMES.get(qual) in (None, cls):
        _NAMES[qual] = cls
        return qual
    n = 2
    while True:
        cand = f"{qual}#{n}"
        if _NAMES.get(cand) in (None, cls):
            _NAMES[cand] = cls
            return cand
        n += 1


def bare_name(name: str) -> str:
    """A storage name without its module qualification and '#n' counter
    ('mymod.ship#2' -> 'ship')."""
    return name.rsplit(".", 1)[-1].split("#", 1)[0]


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


def component(cls=None, *, name: Optional[str] = None, requires=()):
    """Class decorator registering a component type. Calling the class
    returns a `ComponentInstance`; the class itself is the query handle.
    `requires` (ref: #[require]): component classes, or instances carrying
    values, inserted (transitively) wherever this component is spawned or
    inserted on an entity that lacks them; explicit values win."""

    def wrap(cls):
        fields = {k: v for k, v in vars(cls).items() if isinstance(v, Field)}
        spec = ComponentSpec(
            cls, name or _claim_name(cls, _snake(cls.__name__)), fields,
            requires=requires)
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


def expand_required(components):
    """The instances plus every transitively required component not already
    present: explicit components first, then requirements breadth-first
    (ref: the require-graph walk at insert)."""
    out = list(components)
    present = set()
    queue = []
    for inst in components:
        spec = get_spec(inst)
        present.add(spec.name)
        queue.extend(spec.requires)
    while queue:
        req = queue.pop(0)
        inst = req if isinstance(req, ComponentInstance) else req()
        if inst.spec.name in present:
            continue
        present.add(inst.spec.name)
        out.append(inst)
        queue.extend(inst.spec.requires)
    return out


def resource(cls=None, *, name: Optional[str] = None):
    """Like @component but for singleton resources, stored as named dicts
    of 0-d (or fixed-shape) tensors in `state['res']`."""
    return component(cls, name=name) if cls is not None else component(name=name)


def define_component(name: str, fields: dict, requires=()):
    """A component type made at run time (ref: examples/ecs/dynamic.rs):
    `fields` maps field names to `field(...)` descriptors; the class is a
    normal @component stored under `name`."""
    cls = type(name, (), dict(fields))
    return component(cls, name=name, requires=requires)
