"""Queries & views (port of bevy_tpu/ecs/query.py; ref: bevy_ecs query/).

A Query resolves to a boolean row mask (alive ∧ membership ∧ filters) plus
views of whole component columns. System bodies read columns, compute
vectorized results and assign them to the view (`q.transform.translation
= ...`); the assignment is staged and merged after the body as
`where(mask, new, old)`, stamping change ticks.
"""

from __future__ import annotations

from typing import Dict

import torch

from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import get_spec


class Read:
    """Marks a query component as read-only (ref: `&T` vs `&mut T`)."""

    def __init__(self, comp):
        self.comp = comp


class With:
    def __init__(self, comp):
        self.comp = comp


class Without:
    def __init__(self, comp):
        self.comp = comp


class Query:
    def __init__(self, *comps, with_=(), without=()):
        self.comps = []
        self.read_only = set()
        self.with_ = [get_spec(c) for c in with_]
        self.without = [get_spec(c) for c in without]
        for c in comps:
            if isinstance(c, With):
                self.with_.append(get_spec(c.comp))
            elif isinstance(c, Without):
                self.without.append(get_spec(c.comp))
            elif isinstance(c, Read):
                spec = get_spec(c.comp)
                self.read_only.add(spec.name)
                self.comps.append(spec)
            else:
                self.comps.append(get_spec(c))

    def specs(self):
        return (*self.comps, *self.with_, *self.without)

    def build(self, state, world, sysctx):
        for spec in self.specs():
            if spec.name not in state["comp"]:
                raise KeyError(f"component '{spec.name}' has no storage; "
                               f"register or spawn it before running schedules")
        mask = state["ent"]["alive"]
        for spec in self.comps + self.with_:
            mask = mask & state["comp"][spec.name]["has"]
        for spec in self.without:
            mask = mask & ~state["comp"][spec.name]["has"]
        return QueryView(self, state, mask)


class ComponentView:
    """Attribute access to one component's field columns with staged writes."""

    def __init__(self, name, store, writable):
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_store", store)
        object.__setattr__(self, "_writable", writable)
        object.__setattr__(self, "_staged", {})

    def __getattr__(self, fname):
        staged = object.__getattribute__(self, "_staged")
        if fname in staged:
            return staged[fname]
        try:
            return object.__getattribute__(self, "_store")["f"][fname]
        except KeyError:
            raise AttributeError(f"component '{object.__getattribute__(self, '_name')}' "
                                 f"has no field '{fname}'") from None

    def __setattr__(self, fname, value):
        name = object.__getattribute__(self, "_name")
        if not object.__getattribute__(self, "_writable"):
            raise AttributeError(f"component '{name}' is Read-only in this query")
        if fname not in object.__getattribute__(self, "_store")["f"]:
            raise AttributeError(f"component '{name}' has no field '{fname}'")
        object.__getattribute__(self, "_staged")[fname] = value


class QueryView:
    """What a system receives for a Query param: `.mask` (bool rows) and one
    `ComponentView` per queried component under its snake_case name."""

    def __init__(self, query: Query, state, mask):
        self.query = query
        self.mask = mask
        self._views: Dict[str, ComponentView] = {}
        for spec in query.comps:
            view = ComponentView(spec.name, state["comp"][spec.name],
                                 writable=spec.name not in query.read_only)
            self._views[spec.name] = view
            setattr(self, spec.name, view)

    def merge(self, state, tick):
        for name, view in self._views.items():
            staged = object.__getattribute__(view, "_staged")
            if not staged:
                continue
            store = state["comp"][name]
            new_fields = dict(store["f"])
            for fname, val in staged.items():
                old = store["f"][fname]
                bmask = self.mask.reshape(self.mask.shape + (1,) * (old.ndim - 1))
                val = torch.as_tensor(val, dtype=old.dtype, device=old.device)
                new_fields[fname] = torch.where(bmask, val, old)
            new_store = dict(store, f=new_fields)
            new_store["changed"] = torch.where(self.mask, tick, store["changed"])
            state = set_in(state, ("comp", name), new_store)
        return state


class Res:
    """Read-only resource access (ref: Res<T>)."""

    def __init__(self, res):
        self.name = res if isinstance(res, str) else get_spec(res).name

    def build(self, state, world, sysctx):
        return ResView(self.name, state["res"][self.name], writable=False)


class ResMut(Res):
    """Mutable resource access (ref: ResMut<T>)."""

    def build(self, state, world, sysctx):
        return ResView(self.name, state["res"][self.name], writable=True)


class ResView:
    def __init__(self, name, store, writable):
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_store", store)
        object.__setattr__(self, "_writable", writable)
        object.__setattr__(self, "_staged", {})

    def __getattr__(self, fname):
        staged = object.__getattribute__(self, "_staged")
        if fname in staged:
            return staged[fname]
        store = object.__getattribute__(self, "_store")
        if fname in store:
            return store[fname]
        raise AttributeError(f"resource '{object.__getattribute__(self, '_name')}' "
                             f"has no field '{fname}'")

    def __setattr__(self, fname, value):
        if not object.__getattribute__(self, "_writable"):
            raise AttributeError(f"resource '{object.__getattribute__(self, '_name')}' "
                                 f"is read-only (use ResMut)")
        object.__getattribute__(self, "_staged")[fname] = value

    def merge(self, state, tick):
        staged = object.__getattribute__(self, "_staged")
        if not staged:
            return state
        name = object.__getattribute__(self, "_name")
        store = dict(state["res"][name])
        for fname, val in staged.items():
            old = store.get(fname)
            if isinstance(old, torch.Tensor):
                val = torch.as_tensor(val, dtype=old.dtype,
                                      device=old.device).expand(old.shape)
            store[fname] = val
        return set_in(state, ("res", name), store)
