"""The World: host-side structural API over a device-resident state dict
(port of bevy_tpu/ecs/world.py; ref: bevy_ecs World, `world/mod.rs:93`).

Storage model: global dense SoA pools. Every registered component owns,
per field, one `(capacity, *shape)` tensor plus a `(capacity,)` membership
mask; entity id == row index. The state dict keeps the JAX package's
layout (`ent`, `comp`, `res`, `msg`, `obs`, `sys`, `tick`, `frame`), so
the two packages' worlds convert into each other key for key.

Structural edits (register, spawn, insert, remove, despawn, set_field)
happen on the host between frames and write the pools in place; numpy
mirrors track liveness and generations, and registrations, spawns and a
component's first rows bump `structure_version` (what the App's prepare
hooks key on).
Device-tier Commands (ecs/commands.py) edit liveness inside a frame
without touching the mirrors: they mark them stale, and the host calls
that read them (`spawn_batch`, `query_rows`, `entity_count`) copy them
back first, so a frame itself never reads the device.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from bevy_tpu_torch.ecs.component import (
    ComponentInstance, ComponentSpec, component, expand_required, get_spec,
    np_dtype,
)
from bevy_tpu_torch.ecs.entity import Entity


def as_tensor(value, dtype, device):
    """A fresh tensor of `dtype` on `device` (never a view of `value`)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(value, np_dtype(dtype)), device=device)


class World:
    DEFAULT_CAPACITY = 1024

    def __init__(self, capacity: int = DEFAULT_CAPACITY, device="cuda"):
        self.capacity = int(capacity)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("World: no CUDA card here; pass device='cpu' "
                               "to run on the CPU")
        self.structure_version = 0
        self.specs: Dict[str, ComponentSpec] = {}
        dev = self.device
        self.state: Dict[str, Any] = {
            "ent": {
                "alive": torch.zeros(self.capacity, dtype=torch.bool, device=dev),
                "generation": torch.zeros(self.capacity, dtype=torch.int32,
                                          device=dev),
            },
            "comp": {},
            "res": {},
            "msg": {},
            "obs": {},
            "sys": {},
            "tick": torch.tensor(1, dtype=torch.int32, device=dev),
            "frame": torch.tensor(0, dtype=torch.int32, device=dev),
        }
        self._host_alive = np.zeros(self.capacity, bool)
        self._host_gen = np.zeros(self.capacity, np.int32)
        self._host_has: Dict[str, np.ndarray] = {}
        # stale host mirrors: set by device-tier Commands, with the
        # components they spawned or inserted since the last copy-back
        self._device_dirty = False
        self._device_added: set = set()

    def component_rows(self, comp) -> int:
        """Host-known row count of a component (fast paths such as flat
        transform propagation). Copies the mirrors back only when
        device-tier Commands added this component since the last copy, so
        a frame whose commands touch other components reads nothing back;
        a count that device despawns made stale is only ever too high."""
        name = get_spec(comp).name
        if name in self._device_added:
            self._sync()
        has = self._host_has.get(name)
        return 0 if has is None else int(has.sum())

    # ------------------------------------------------------------------
    # liveness mirrors (ref: the JAX package's mark_device_dirty)

    def mark_device_dirty(self, added=()):
        """The device state's liveness changed behind the host mirrors;
        `added`: names of components given to rows."""
        self._device_dirty = True
        self._device_added.update(added)

    def _sync(self):
        if not self._device_dirty:
            return
        self._host_alive = self.state["ent"]["alive"].cpu().numpy().copy()
        self._host_gen = self.state["ent"]["generation"].cpu().numpy().copy()
        for name in self.specs:
            self._host_has[name] = \
                self.state["comp"][name]["has"].cpu().numpy().copy()
        self._device_dirty = False
        self._device_added.clear()

    # ------------------------------------------------------------------
    # registration

    def register_component(self, comp) -> ComponentSpec:
        spec = get_spec(comp)
        if spec.name in self.specs:
            if self.specs[spec.name] is not spec:
                raise ValueError(f"component name {spec.name!r} already "
                                 f"registered by a different type")
            return spec
        self.specs[spec.name] = spec
        n, dev = self.capacity, self.device
        self.state["comp"][spec.name] = {
            "has": torch.zeros(n, dtype=torch.bool, device=dev),
            "added": torch.zeros(n, dtype=torch.int32, device=dev),
            "changed": torch.zeros(n, dtype=torch.int32, device=dev),
            "removed": torch.zeros(n, dtype=torch.int32, device=dev),
            "f": {fname: torch.zeros((n,) + fld.shape, dtype=fld.dtype,
                                     device=dev)
                  for fname, fld in spec.fields.items()},
        }
        self._host_has[spec.name] = np.zeros(n, bool)
        self.structure_version += 1
        # required components get storage too (ref: #[require])
        for req in spec.requires:
            self.register_component(get_spec(req))
        return spec

    def add_message(self, msg, capacity: int = 1024) -> ComponentSpec:
        """Register a double-buffered message queue (ref: Messages<M>
        two-frame ring, message/messages.rs:95): per field a (2, capacity,
        *shape) tensor, `count` (2,), per-slot write tick `t` (2,
        capacity) and the current buffer `cur` (ecs/message.py)."""
        spec = get_spec(msg)
        if spec.name in self.state["msg"]:
            return spec
        dev = self.device
        self.state["msg"][spec.name] = {
            "f": {fname: torch.zeros((2, capacity) + fld.shape,
                                     dtype=fld.dtype, device=dev)
                  for fname, fld in spec.fields.items()},
            "count": torch.zeros(2, dtype=torch.int32, device=dev),
            "t": torch.zeros((2, capacity), dtype=torch.int32, device=dev),
            "cur": torch.zeros((), dtype=torch.int32, device=dev),
        }
        self.structure_version += 1
        return spec

    # ------------------------------------------------------------------
    # resources (named dicts of tensors in state['res'])

    def insert_resource(self, res, value: Optional[Any] = None):
        if isinstance(res, ComponentInstance):
            spec = res.spec
            self.state["res"][spec.name] = {
                fname: as_tensor(res.values.get(fname, fld.default),
                                 fld.dtype, self.device)
                for fname, fld in spec.fields.items()}
            name = spec.name
        elif isinstance(res, str):
            name = res
            self.state["res"][name] = value
        else:
            raise TypeError("insert_resource expects a component instance "
                            "or (name, dict of tensors)")
        self.structure_version += 1
        return name

    def has_resource(self, res) -> bool:
        return _res_name(res) in self.state["res"]

    def resource(self, res):
        """Host copy of a resource: a namespace of numpy values."""
        val = self.state["res"][_res_name(res)]
        if isinstance(val, dict):
            return SimpleNamespace(**{k: _host(v) for k, v in val.items()})
        return _host(val)

    def resource_raw(self, res):
        return self.state["res"][_res_name(res)]

    def set_resource_field(self, res, fname: str, value):
        """Host-tier write of one resource field (a new tensor of the
        field's dtype)."""
        name = _res_name(res)
        store = dict(self.state["res"][name])
        old = store[fname]
        store[fname] = as_tensor(value, old.dtype, self.device) \
            if isinstance(old, torch.Tensor) else value
        self.state["res"][name] = store
    # ------------------------------------------------------------------
    # host-tier structural ops

    def grow(self, min_capacity: int):
        self._sync()
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        pad = new_cap - self.capacity

        def pad0(t):
            return torch.cat([t, torch.zeros((pad,) + t.shape[1:],
                                             dtype=t.dtype, device=t.device)])

        self.state["ent"] = {k: pad0(v) for k, v in self.state["ent"].items()}
        self.state["comp"] = {
            name: {k: ({f: pad0(a) for f, a in v.items()} if k == "f"
                       else pad0(v)) for k, v in c.items()}
            for name, c in self.state["comp"].items()}
        self._host_alive = np.pad(self._host_alive, (0, pad))
        self._host_gen = np.pad(self._host_gen, (0, pad))
        for name in self._host_has:
            self._host_has[name] = np.pad(self._host_has[name], (0, pad))
        self.capacity = new_cap
        self.structure_version += 1

    def spawn(self, *components: ComponentInstance) -> Entity:
        rows = self.spawn_batch(list(components), 1)
        return Entity(int(rows[0]), int(self._host_gen[rows[0]]))

    def spawn_batch(self, components: Sequence[ComponentInstance],
                    count: int) -> np.ndarray:
        """Bulk spawn `count` entities sharing a component set; field values
        may be scalars (broadcast) or (count, *shape) arrays. Returns row
        indices (ref: World::spawn_batch). Required components are added
        with their defaults."""
        components = expand_required(components)
        self._sync()
        free = np.flatnonzero(~self._host_alive)
        if len(free) < count:
            self.grow(self.capacity + (count - len(free)))
            free = np.flatnonzero(~self._host_alive)
        rows = free[:count]
        self._host_alive[rows] = True
        trows = torch.as_tensor(rows, device=self.device)
        # host structural ops stamp strictly after any earlier tick
        tick = self.state["tick"] + 1
        self.state["tick"] = tick
        self.state["ent"]["alive"][trows] = True
        for inst in components:
            spec = self.register_component(get_spec(inst))
            if not isinstance(inst, ComponentInstance):
                inst = ComponentInstance(spec, {})
            self._host_has[spec.name][rows] = True
            store = self.state["comp"][spec.name]
            for fname, fld in spec.fields.items():
                val = inst.values.get(fname, fld.default)
                store["f"][fname][trows] = as_tensor(
                    val, fld.dtype, self.device).expand((count,) + fld.shape)
            store["has"][trows] = True
            store["added"][trows] = tick
            store["changed"][trows] = tick
        self.structure_version += 1
        return rows

    def insert(self, entity: Union[Entity, int],
               *components: ComponentInstance):
        """Host-tier insert (ref: EntityWorldMut::insert): every field of
        each component on the entity's row (unspecified fields take their
        defaults), its membership and its added / changed ticks. Required
        components the entity lacks come with their defaults; they never
        overwrite ones it has."""
        self._sync()
        row = entity.index if isinstance(entity, Entity) else int(entity)
        expanded = expand_required(components)
        components = list(components) + [
            inst for inst in expanded[len(components):]
            if not self.has(row, inst.spec)]
        trow = torch.as_tensor([row], device=self.device)
        tick = self.state["tick"] + 1  # see spawn_batch
        self.state["tick"] = tick
        for inst in components:
            spec = self.register_component(inst.spec)
            if not self._host_has[spec.name].any():
                self.structure_version += 1    # 0 -> nonzero rows
            self._host_has[spec.name][row] = True
            store = self.state["comp"][spec.name]
            for fname, fld in spec.fields.items():
                val = inst.values.get(fname, fld.default)
                store["f"][fname][trow] = as_tensor(
                    val, fld.dtype, self.device).expand((1,) + fld.shape)
            store["has"][trow] = True
            store["added"][trow] = tick
            store["changed"][trow] = tick

    def remove(self, entity: Union[Entity, int], *comps):
        """Host-tier remove: clears membership and stamps the `removed`
        tick (what Removed filters and OnRemove observers read)."""
        self._sync()
        row = _row(entity)
        tick = self.state["tick"] + 1  # see spawn_batch
        self.state["tick"] = tick
        for comp in comps:
            spec = get_spec(comp)
            if spec.name not in self.specs:
                continue
            self._host_has[spec.name][row] = False
            store = self.state["comp"][spec.name]
            store["has"][row] = False
            store["removed"][row] = tick

    def despawn(self, entity: Union[Entity, int]) -> bool:
        """Host-tier despawn: the row dies, its generation bumps, and each
        of its components is stamped removed. False if it was not alive."""
        self._sync()
        row = _row(entity)
        if not self._host_alive[row]:
            return False
        self._host_alive[row] = False
        self._host_gen[row] += 1
        self.state["ent"]["alive"][row] = False
        self.state["ent"]["generation"][row] += 1
        tick = self.state["tick"] + 1  # see spawn_batch
        self.state["tick"] = tick
        for name in self.specs:
            if self._host_has[name][row]:
                self._host_has[name][row] = False
                store = self.state["comp"][name]
                store["has"][row] = False
                store["removed"][row] = tick
        return True

    def set_field(self, entity: Union[Entity, int], comp, fname: str,
                  value):
        """Host-tier write of one field of an entity's component (its other
        fields and membership stay); stamps the changed tick."""
        row = _row(entity)
        spec = get_spec(comp)
        fld = spec.fields[fname]
        store = self.state["comp"][spec.name]
        tick = self.state["tick"] + 1  # see spawn_batch
        self.state["tick"] = tick
        store["f"][fname][row] = as_tensor(value, fld.dtype,
                                           self.device).expand(fld.shape)
        store["changed"][row] = tick

    def clone_entity(self, entity: Union[Entity, int], without=()) -> Entity:
        """Spawn a copy of an entity's components, minus `without` (ref:
        EntityCloner): one read of the row a component, between frames."""
        self._sync()
        row = _row(entity)
        if not self._host_alive[row]:
            raise ValueError(f"clone_entity: entity row {row} is not alive")
        skip = {get_spec(c).name for c in without}
        insts = [ComponentInstance(spec, {
            f: a[row].cpu().numpy()
            for f, a in self.state["comp"][name]["f"].items()})
            for name, spec in self.specs.items()
            if name not in skip and self._host_has[name][row]]
        return self.spawn(*insts)

    # ------------------------------------------------------------------
    # host-tier reads

    @property
    def num_alive(self) -> int:
        self._sync()
        return int(self._host_alive.sum())

    def is_alive(self, entity: Entity) -> bool:
        self._sync()
        return bool(self._host_alive[entity.index]) and \
            int(self._host_gen[entity.index]) == entity.generation

    def has(self, entity: Union[Entity, int], comp) -> bool:
        self._sync()
        name = get_spec(comp).name
        return name in self._host_has and bool(
            self._host_has[name][_row(entity)])

    def mask_of(self, *comps) -> torch.Tensor:
        """Device (capacity,) mask of live rows holding every `comps`."""
        m = self.state["ent"]["alive"]
        for comp in comps:
            m = m & self.state["comp"][get_spec(comp).name]["has"]
        return m

    def get(self, entity: Union[Entity, int], comp):
        """Host copy of one entity's component as a namespace of numpy
        values."""
        row = entity.index if isinstance(entity, Entity) else int(entity)
        store = self.state["comp"][get_spec(comp).name]
        return SimpleNamespace(**{f: a[row].cpu().numpy()
                                  for f, a in store["f"].items()})

    def column(self, comp, fname: str) -> torch.Tensor:
        """Whole field column (capacity rows, on the world's device)."""
        return self.state["comp"][get_spec(comp).name]["f"][fname]

    def query_rows(self, *comps) -> np.ndarray:
        self._sync()
        m = self._host_alive.copy()
        for comp in comps:
            m &= self._host_has[get_spec(comp).name]
        return np.flatnonzero(m)

    def entity_count(self, *comps) -> int:
        return len(self.query_rows(*comps))


def _row(entity) -> int:
    return entity.index if isinstance(entity, Entity) else int(entity)


def _res_name(res) -> str:
    return res if isinstance(res, str) else get_spec(res).name


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


@component
class Disabled:
    """Marker excluding an entity from every query that does not mention
    Disabled itself (ref: bevy_ecs entity_disabling.rs —
    DefaultQueryFilters). Insert to disable, remove to re-enable."""
