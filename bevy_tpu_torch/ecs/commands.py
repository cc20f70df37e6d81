"""Device-tier Commands: masked structural edits inside the frame (port of
bevy_tpu/ecs/commands.py; ref: Commands `system/commands/mod.rs:106` +
ApplyDeferred).

Structural edits are masked writes against the global fixed-capacity
pools: despawn clears alive bits and bumps generations, spawn claims the
lowest free rows up to a static per-call budget. The ops are recorded
during the system body and applied in order at the system's merge (the
reference's deferred semantics). Nothing here reads the device from the
host: free rows are claimed with a cumsum rank and a scatter at static
shapes, and the World's host mirrors are only marked stale.

Required components (`#[require]`) come along: `spawn` adds them with
their defaults, `insert` only to rows that lack them.
"""

from __future__ import annotations

from typing import Any, List

import torch

from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import (
    ComponentInstance, expand_required, get_spec,
)


class Commands:
    def __init__(self, spawn_comps=(), budget: int = 0):
        """`spawn_comps`/`budget`: components this system may spawn (their
        storage is registered with the system) and the static per-call row
        budget of `spawn`."""
        self.spawn_comps = [get_spec(c) for c in spawn_comps]
        self.budget = budget

    def reads(self):
        return set()

    def writes(self):
        # deferred, as the reference's: no conflict with component access
        return set()

    def build(self, state, world, sysctx):
        return CommandsView(self, world)


def _scatter_rows(col, rows, val):
    """`col` with rows `rows` (int64; == len(col) drops the write) set to
    `val`, as a new tensor."""
    ext = torch.cat([col, col[:1]])
    ext[rows] = val
    return ext[:col.shape[0]]


class CommandsView:
    def __init__(self, param: Commands, world):
        self._param = param
        self._world = world
        self._ops: List[Any] = []

    def despawn(self, mask):
        """Despawn every row where `mask` (bool (capacity,)) is True."""
        self._ops.append(("despawn", mask))

    def despawn_entities(self, rows, valid=None):
        """Despawn by row index; `valid` masks which lanes count."""
        self._ops.append(("despawn_rows", rows, valid))

    def spawn(self, *components: ComponentInstance, count=None, budget=None):
        """Spawn up to `budget` entities (static), `count` of them real (an
        int or a device scalar). Field values: (budget, *shape) or
        broadcastable. Rows past the pool's free rows are dropped."""
        budget = budget or self._param.budget
        if budget <= 0:
            raise ValueError("Commands.spawn needs a positive budget "
                             "(declare via Commands(budget=N) or "
                             "spawn(budget=N))")
        count = budget if count is None else count
        self._ops.append(("spawn", expand_required(components), count,
                          budget))

    def insert(self, mask, *components: ComponentInstance):
        """Add or overwrite components on every row where `mask` is True;
        required components go only to rows that lack them."""
        expanded = expand_required(components)
        self._ops.append(("insert", mask, tuple(expanded[:len(components)])))
        for inst in expanded[len(components):]:
            self._ops.append(("insert_missing", mask, (inst,)))

    def remove(self, mask, *comps):
        self._ops.append(("remove", mask, [get_spec(c) for c in comps]))

    def merge(self, state, tick):
        if not self._ops:
            return state
        added = set()
        for op in self._ops:
            kind = op[0]
            if kind == "despawn":
                state = _apply_despawn(state, op[1])
            elif kind == "despawn_rows":
                _, rows, valid = op
                alive = state["ent"]["alive"]
                n = alive.shape[0]
                rows = torch.as_tensor(rows, device=alive.device).long()
                if valid is not None:
                    rows = torch.where(valid, rows, n)
                mask = torch.zeros(n + 1, dtype=torch.bool,
                                   device=alive.device)
                mask[rows] = True
                state = _apply_despawn(state, mask[:n])
            elif kind == "spawn":
                _, components, count, budget = op
                state = _apply_spawn(state, components, count, budget, tick)
                added.update(get_spec(c).name for c in components)
            elif kind == "insert":
                _, mask, components = op
                state = _apply_insert(state, mask, components, tick)
                added.update(get_spec(c).name for c in components)
            elif kind == "insert_missing":
                _, mask, (inst,) = op
                have = state["comp"][inst.spec.name]["has"]
                state = _apply_insert(state, mask & ~have, [inst], tick)
                added.add(inst.spec.name)
            elif kind == "remove":
                _, mask, specs = op
                for spec in specs:
                    store = state["comp"][spec.name]
                    state = set_in(state, ("comp", spec.name), dict(
                        store, has=store["has"] & ~mask,
                        removed=torch.where(mask & store["has"],
                                            state["tick"],
                                            store["removed"])))
        self._world.mark_device_dirty(added)
        return state


def _apply_despawn(state, mask):
    mask = mask & state["ent"]["alive"]
    tick = state["tick"]
    ent = {"alive": state["ent"]["alive"] & ~mask,
           "generation": state["ent"]["generation"] + mask.to(torch.int32)}
    state = set_in(state, ("ent",), ent)
    comp = {name: dict(store, has=store["has"] & ~mask,
                       removed=torch.where(mask & store["has"], tick,
                                           store["removed"]))
            for name, store in state["comp"].items()}
    return set_in(state, ("comp",), comp)


def _apply_spawn(state, components, count, budget, tick):
    """Claim the `count` lowest free rows (at most `budget`): each free
    row's rank among the free rows is a cumsum, and a scatter of row ids
    by rank lists them (the reference's nonzero(size=budget) without its
    host read)."""
    alive = state["ent"]["alive"]
    n, dev = alive.shape[0], alive.device
    free = ~alive
    rank = torch.cumsum(free.to(torch.int32), 0) - 1
    slot = torch.where(free & (rank < budget), rank, budget).long()
    buf = torch.full((budget + 1,), n, dtype=torch.int64, device=dev)
    buf.scatter_(0, slot, torch.arange(n, device=dev))
    lane = torch.arange(budget, device=dev)
    rows = torch.where((lane < count) & (buf[:budget] < n), buf[:budget], n)
    state = set_in(state, ("ent", "alive"),
                   _scatter_rows(alive, rows, True))
    for inst in components:
        spec = get_spec(inst)
        values = inst.values if isinstance(inst, ComponentInstance) else {}
        store = state["comp"][spec.name]
        new_fields = dict(store["f"])
        for fname, fld in spec.fields.items():
            val = torch.as_tensor(values.get(fname, fld.default),
                                  dtype=fld.dtype, device=dev)
            new_fields[fname] = _scatter_rows(
                store["f"][fname], rows, val.expand((budget,) + fld.shape))
        state = set_in(state, ("comp", spec.name), {
            "has": _scatter_rows(store["has"], rows, True),
            "added": _scatter_rows(store["added"], rows, tick),
            "changed": _scatter_rows(store["changed"], rows, tick),
            "removed": store["removed"],
            "f": new_fields,
        })
    return state


def _apply_insert(state, mask, components, tick):
    for inst in components:
        spec = inst.spec
        store = state["comp"][spec.name]
        new_fields = dict(store["f"])
        for fname in spec.fields:
            if fname not in inst.values:
                continue
            old = store["f"][fname]
            val = torch.as_tensor(inst.values[fname], dtype=old.dtype,
                                  device=old.device).expand(old.shape)
            bmask = mask.reshape(mask.shape + (1,) * (old.ndim - 1))
            new_fields[fname] = torch.where(bmask, val, old)
        state = set_in(state, ("comp", spec.name), {
            "has": store["has"] | mask,
            "added": torch.where(mask & ~store["has"], tick, store["added"]),
            "changed": torch.where(mask, tick, store["changed"]),
            "removed": store["removed"],
            "f": new_fields,
        })
    return state
