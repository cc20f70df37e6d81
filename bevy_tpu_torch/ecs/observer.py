"""Observers — push-based event reactions (port of bevy_tpu/ecs/observer.py;
ref: bevy_ecs observer/ — `On<E>` `observer/system_param.rs:38`,
World::add_observer `observer/mod.rs:55`).

`Trigger` writes events into a single-frame device buffer (per field a
(capacity, *shape) tensor and a device `count`); the App splices observer
systems into the frame right after the last schedule holding a
`Trigger(ev)` param, where they read the buffer vectorized (`budget`
slots masked by the count, never a host read); the buffer clears at frame
end. Lifecycle observers (OnAdd / OnInsert / OnRemove) read the component
ticks through a `LifecycleMask` param and are spliced after frame start
and after every Commands-bearing item.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import component, get_spec


def event(cls=None, **kw):
    """Decorator registering an observer-event struct (ref: #[derive(Event)]);
    the same field machinery as components."""
    return component(cls, **kw) if cls is not None else component(**kw)


def _scatter(col, rows, val):
    """`col` with rows `rows` (int64; == len(col) drops the write) set to
    `val`, as a new tensor."""
    ext = torch.cat([col, col[:1]])
    ext[rows] = val
    return ext[:col.shape[0]]


class Trigger:
    """System param for firing events (ref: Commands::trigger)."""

    def __init__(self, ev, budget: int = 64):
        self.spec = get_spec(ev)
        self.budget = budget

    def reads(self):
        return set()

    def writes(self):
        return {f"obs:{self.spec.name}"}

    def build(self, state, world, sysctx):
        return TriggerView(self)


class TriggerView:
    def __init__(self, param):
        self._param = param
        self._sends = []

    def trigger(self, count=None, **fields):
        """Fire up to `budget` events, `count` (an int or a device scalar)
        of them real."""
        self._sends.append((count, fields))

    def merge(self, state, tick):
        if not self._sends:
            return state
        name = self._param.spec.name
        budget = self._param.budget
        store = dict(state["obs"][name])
        fields = dict(store["f"])
        cnt0 = store["count"]
        cap = next(iter(fields.values())).shape[0]
        lane = torch.arange(budget, device=cnt0.device)
        for count, vals in self._sends:
            count = budget if count is None else count
            rows = store["count"] + lane
            valid = (lane < count) & (rows < cap)
            rows = torch.where(valid, rows, cap).long()
            for fname, fld in self._param.spec.fields.items():
                val = torch.as_tensor(vals.get(fname, fld.default),
                                      dtype=fld.dtype, device=cnt0.device)
                fields[fname] = _scatter(fields[fname], rows,
                                         val.expand((budget,) + fld.shape))
            store["count"] = store["count"] + valid.sum(dtype=torch.int32)
        store["f"] = fields
        return set_in(state, ("obs", name), store)


class On:
    """Observer system param: a vectorized view of this frame's events
    (ref: On<E>). `.read()` -> (fields dict, valid mask); `.count()`.
    `bubble=True` also reads a parent-link component (`via`, default
    ChildOf) so `bubble_mask()` can expand event targets (`target_field`,
    entity rows) up the ancestor chain (ref: observer Traversal)."""

    def __init__(self, ev, bubble=False, target_field="row",
                 max_depth=16, via=None, parent_field="parent"):
        self.spec = get_spec(ev)
        self.bubble = bubble
        self.target_field = target_field
        self.max_depth = max_depth
        self.via_name = get_spec(via).name if via is not None else "child_of"
        self.parent_field = parent_field

    def reads(self):
        r = {f"obs:{self.spec.name}"}
        if self.bubble:
            r.add(f"comp:{self.via_name}")
        return r

    def writes(self):
        return set()

    def build(self, state, world, sysctx):
        via = state["comp"].get(self.via_name) if self.bubble else None
        return OnView(state["obs"][self.spec.name], via, self.target_field,
                      self.max_depth, self.parent_field)


def bubble_rows(parent_col, has_childof, rows, valid, max_depth=16):
    """Vectorized ancestor expansion (ref: traversal.rs): rows (E,) target
    rows, valid (E,) bool. Returns a (capacity,) bool mask of every target
    and every ancestor on its chain, `max_depth` levels up."""
    cap = parent_col.shape[0]
    cur = torch.where(valid, rows.long(), cap)   # cap = out of range
    mask = torch.zeros(cap, dtype=torch.bool, device=parent_col.device)
    for _ in range(max_depth):
        mask = _scatter(mask, cur, True)
        safe = cur.clamp(0, cap - 1)
        cur = torch.where(has_childof[safe] & (cur < cap),
                          parent_col[safe].long(), cap)
    return mask


class OnView:
    def __init__(self, store, child_of=None, target_field="row",
                 max_depth=16, parent_field="parent"):
        self._store = store
        self._child_of = child_of
        self._target_field = target_field
        self._max_depth = max_depth
        self._parent_field = parent_field

    def read(self):
        cap = next(iter(self._store["f"].values())).shape[0]
        lane = torch.arange(cap, dtype=torch.int32,
                            device=self._store["count"].device)
        return dict(self._store["f"]), lane < self._store["count"]

    def count(self):
        return self._store["count"]

    def bubble_mask(self):
        """(world capacity,) bool: this frame's event targets and all their
        ancestors (needs On(ev, bubble=True))."""
        if self._child_of is None:
            raise ValueError("construct the param as On(ev, bubble=True)")
        fields, valid = self.read()
        return bubble_rows(self._child_of["f"][self._parent_field],
                           self._child_of["has"], fields[self._target_field],
                           valid, self._max_depth)

    def merge(self, state, tick):
        return state


class LifecycleTrigger:
    """A lifecycle observer trigger (ref: the Add / Insert / Remove events,
    bevy_ecs/src/lifecycle.rs); made by OnAdd / OnInsert / OnRemove."""

    def __init__(self, kind: str, comp):
        self.kind = kind
        self.spec = get_spec(comp)


def OnAdd(comp) -> LifecycleTrigger:
    """Fires for rows that newly gained `comp` (spawn or 0 -> 1 insert)."""
    return LifecycleTrigger("add", comp)


def OnInsert(comp) -> LifecycleTrigger:
    """Fires for rows whose `comp` data was written (a superset of the
    reference's: a query write stamps the same `changed` tick)."""
    return LifecycleTrigger("insert", comp)


def OnRemove(comp) -> LifecycleTrigger:
    """Fires for rows that lost `comp` (remove or despawn) since the
    observer last ran; the columns stay readable."""
    return LifecycleTrigger("remove", comp)


class LifecycleMask:
    """System param for lifecycle observer bodies: `.mask` is the bool
    (capacity,) row mask the trigger fired for since this system's last
    run (the Added / Changed / Removed tick windows), so an observer
    spliced several times a frame never fires twice for one edit."""

    def __init__(self, trigger: LifecycleTrigger):
        self.trigger = trigger

    def reads(self):
        return {f"comp:{self.trigger.spec.name}"}

    def writes(self):
        return set()

    def build(self, state, world, sysctx):
        c = state["comp"][self.trigger.spec.name]
        last_run = state["sys"][sysctx["id"]]["last_run"]
        k = self.trigger.kind
        if k == "add":
            mask = c["has"] & (c["added"] > last_run)
        elif k == "insert":
            mask = c["has"] & (c["changed"] > last_run)
        else:
            mask = ~c["has"] & (c["removed"] > last_run)
        return _LifecycleView(mask)


class _LifecycleView:
    def __init__(self, mask):
        self.mask = mask

    def count(self):
        return self.mask.sum(dtype=torch.int32)

    def merge(self, state, tick):
        return state


def register_event_storage(world, ev, capacity: int = 64):
    """The event buffer of `ev` in state['obs'] (a marker event gets one
    int32 column so the buffer has a capacity)."""
    spec = get_spec(ev)
    if spec.name in world.state["obs"]:
        return spec
    dev = world.device
    fields = {fname: torch.zeros((capacity,) + fld.shape, dtype=fld.dtype,
                                 device=dev)
              for fname, fld in spec.fields.items()}
    if not fields:
        fields["_"] = torch.zeros(capacity, dtype=torch.int32, device=dev)
    world.state["obs"][spec.name] = {
        "f": fields, "count": torch.zeros((), dtype=torch.int32, device=dev)}
    world.structure_version += 1
    return spec


def clear_observer_buffers(state):
    """Frame-final clear (observers see only the same frame's events)."""
    if not state["obs"]:
        return state
    return set_in(state, ("obs",), {
        name: dict(store, count=torch.zeros_like(store["count"]))
        for name, store in state["obs"].items()})
