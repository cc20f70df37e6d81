"""Queries & views (port of bevy_tpu/ecs/query.py; ref: bevy_ecs query/ —
QueryState `query/state.rs:79`, access sets `query/access.rs`, filters
With/Without/Changed/Added).

A Query resolves to a boolean row mask (alive ∧ membership ∧ filters) plus
views of whole component columns. System bodies read columns, compute
vectorized results and assign them to the view (`q.transform.translation
= ...`); the assignment is staged and merged after the body as
`where(mask, new, old)`, stamping change ticks. Every param has
`reads()` / `writes()` access sets (the schedule's ambiguity check).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
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


class Changed:
    """Rows whose component was written since the system last ran."""

    def __init__(self, comp):
        self.comp = comp


class Added:
    """Rows that gained the component since the system last ran."""

    def __init__(self, comp):
        self.comp = comp


class Removed:
    """Rows whose component was removed since the system last ran (ref:
    RemovedComponents); despawned rows included."""

    def __init__(self, comp):
        self.comp = comp


_FILTERS = {With: "with_", Without: "without", Changed: "changed",
            Added: "added", Removed: "removed"}


class QueryBuilder:
    """Runtime-composed query (ref: QueryBuilder, query/builder.rs)::

        q = QueryBuilder().data(Pos).ref_(Vel).with_(Alive).build()
    """

    def __init__(self):
        self._comps = []
        self._kw = {k: [] for k in _FILTERS.values()}

    def data(self, comp):
        """Mutable access (ref: builder.data::<&mut T>())."""
        self._comps.append(comp)
        return self

    def ref_(self, comp):
        """Read-only access (ref: builder.data::<&T>())."""
        self._comps.append(Read(comp))
        return self

    def with_(self, comp):
        self._kw["with_"].append(comp)
        return self

    def without(self, comp):
        self._kw["without"].append(comp)
        return self

    def changed(self, comp):
        self._kw["changed"].append(comp)
        return self

    def added(self, comp):
        self._kw["added"].append(comp)
        return self

    def removed(self, comp):
        self._kw["removed"].append(comp)
        return self

    def build(self) -> "Query":
        return Query(*self._comps, **self._kw)


class Query:
    def __init__(self, *comps, with_=(), without=(), changed=(), added=(),
                 removed=()):
        self.comps = []
        self.read_only = set()
        self.with_ = [get_spec(c) for c in with_]
        self.without = [get_spec(c) for c in without]
        self.changed = [get_spec(c) for c in changed]
        self.added = [get_spec(c) for c in added]
        self.removed = [get_spec(c) for c in removed]
        for c in comps:
            kind = _FILTERS.get(type(c))
            if kind is not None:
                getattr(self, kind).append(get_spec(c.comp))
            elif isinstance(c, Read):
                spec = get_spec(c.comp)
                self.read_only.add(spec.name)
                self.comps.append(spec)
            else:
                self.comps.append(get_spec(c))

    def specs(self):
        return (*self.comps, *self.with_, *self.without, *self.changed,
                *self.added, *self.removed)

    # -- access sets for ambiguity analysis (ref: FilteredAccessSet) -----
    def reads(self):
        out = {f"comp:{s.name}" for s in self.comps
               if s.name in self.read_only}
        return out | {f"comp:{s.name}" for s in self.specs()[len(self.comps):]}

    def writes(self):
        return {f"comp:{s.name}" for s in self.comps
                if s.name not in self.read_only}

    def build(self, state, world, sysctx):
        for spec in self.specs():
            if spec.name not in state["comp"]:
                raise KeyError(f"component '{spec.name}' has no storage; "
                               f"register or spawn it before running schedules")
        mask = state["ent"]["alive"]
        # default query filter (ref: entity_disabling.rs): rows carrying
        # Disabled are skipped unless the query mentions Disabled
        if "disabled" in state["comp"] and \
                not any(s.name == "disabled" for s in self.specs()):
            mask = mask & ~state["comp"]["disabled"]["has"]
        for spec in self.comps + self.with_:
            mask = mask & state["comp"][spec.name]["has"]
        for spec in self.without:
            mask = mask & ~state["comp"][spec.name]["has"]
        last_run = state["sys"][sysctx["id"]]["last_run"]
        for spec in self.changed:
            c = state["comp"][spec.name]
            mask = mask & c["has"] & (c["changed"] > last_run)
        for spec in self.added:
            c = state["comp"][spec.name]
            mask = mask & c["has"] & (c["added"] > last_run)
        for spec in self.removed:
            # a pure-Removed query does not AND alive: despawns show
            c = state["comp"][spec.name]
            rm = ~c["has"] & (c["removed"] > last_run)
            mask = rm if not self.comps and not self.with_ else mask & rm
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
    """What a system receives for a Query param: `.mask` (bool rows),
    `.entities` (row indices) and one `ComponentView` per queried component
    under its storage name (and its short snake name)."""

    def __init__(self, query: Query, state, mask):
        self.query = query
        self.mask = mask
        self._state = state          # whole-state view (alive, generations)
        self._views: Dict[str, ComponentView] = {}
        for spec in query.comps:
            view = ComponentView(spec.name, state["comp"][spec.name],
                                 writable=spec.name not in query.read_only)
            self._views[spec.name] = view
            setattr(self, spec.name, view)
            if spec.attr != spec.name and not hasattr(self, spec.attr):
                setattr(self, spec.attr, view)

    @property
    def entities(self):
        return torch.arange(self.mask.shape[0], dtype=torch.int32,
                            device=self.mask.device)

    def count(self):
        return self.mask.sum(dtype=torch.int32)

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

    def reads(self):
        return {f"res:{self.name}"}

    def writes(self):
        return set()

    def build(self, state, world, sysctx):
        return ResView(self.name, state["res"][self.name], writable=False)


class ResMut(Res):
    """Mutable resource access (ref: ResMut<T>)."""

    def reads(self):
        return set()

    def writes(self):
        return {f"res:{self.name}"}

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


class Local:
    """Per-system persistent state (ref: Local<T>): a tensor or a dict of
    tensors kept in state['sys'][id]['local'][param_name]."""

    def __init__(self, default):
        self.default = default
        self.param_name = None  # filled by System

    def reads(self):
        return set()

    def writes(self):
        return set()

    def build(self, state, world, sysctx):
        return LocalView(sysctx["id"], self.param_name,
                         state["sys"][sysctx["id"]]["local"][self.param_name])


class LocalView:
    def __init__(self, sys_id, name, value):
        self._sys_id = sys_id
        self._name = name
        self._value = value
        self._dirty = False

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = v
        self._dirty = True

    def merge(self, state, tick):
        if not self._dirty:
            return state
        return set_in(state, ("sys", self._sys_id, "local", self._name),
                      self._value)


def pair_combinations(mask):
    """All unordered row pairs of a query (ref: Query::iter_combinations):
    the static upper triangle of the capacity x capacity grid as flat
    (idx_i, idx_j, valid) of length C*(C-1)/2, valid where both rows
    match. O(C^2): for small pools, like the reference's O(N^2) iterator."""
    c = mask.shape[0]
    iu = np.triu_indices(c, k=1)
    idx_i = torch.as_tensor(iu[0].astype(np.int64), device=mask.device)
    idx_j = torch.as_tensor(iu[1].astype(np.int64), device=mask.device)
    return idx_i, idx_j, mask[idx_i] & mask[idx_j]


class Single(Query):
    """Query expecting at most one match (ref: Single<T>). Field reads give
    the matched row's values, writes land on that row only; `.exists` is a
    device bool. With no match, reads give row 0's values: guard with
    `.exists` (the reference skips the system instead)."""

    def build(self, state, world, sysctx):
        return SingleView(super().build(state, world, sysctx))


class SingleView:
    def __init__(self, qview):
        object.__setattr__(self, "_q", qview)
        # the first matching row, as a (1,) index: gathers and scatters by
        # it keep the frame on the device (a 0-d index reads it back)
        idx = torch.argmax(qview.mask.to(torch.uint8)).reshape(1)
        object.__setattr__(self, "row", idx[0])
        object.__setattr__(self, "exists", qview.mask.any())
        for name, cview in qview._views.items():
            view = _SingleComponentView(cview, idx, self.exists)
            object.__setattr__(self, name, view)

    def merge(self, state, tick):
        return object.__getattribute__(self, "_q").merge(state, tick)


class _SingleComponentView:
    def __init__(self, cview, idx, exists):
        object.__setattr__(self, "_c", cview)
        object.__setattr__(self, "_idx", idx)
        object.__setattr__(self, "_exists", exists)

    def __getattr__(self, fname):
        col = getattr(object.__getattribute__(self, "_c"), fname)
        return col.index_select(0, object.__getattribute__(self, "_idx"))[0]

    def __setattr__(self, fname, value):
        c = object.__getattribute__(self, "_c")
        idx = object.__getattribute__(self, "_idx")
        ok = object.__getattribute__(self, "_exists")
        col = getattr(c, fname)
        cur = col.index_select(0, idx)
        val = torch.as_tensor(value, dtype=col.dtype,
                              device=col.device).expand(cur.shape[1:])
        setattr(c, fname, col.index_copy(0, idx, torch.where(ok, val[None],
                                                             cur)))
