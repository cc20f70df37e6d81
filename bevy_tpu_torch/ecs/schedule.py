"""Schedules (port of bevy_tpu/ecs/schedule.py; ref: bevy_ecs schedule/).

Order is explicit `before`/`after` edges (to systems, names or set names),
set-level ordering from `configure_set`, and chained tuples —
topologically sorted with stable insertion order (Kahn), cycle check
included. Systems then run one after another, eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from bevy_tpu_torch.ecs.system import System


@dataclass
class SystemEntry:
    system: System
    after: Tuple = ()
    before: Tuple = ()
    sets: Tuple[str, ...] = ()


@dataclass
class SetEntry:
    name: str
    after: Tuple = ()
    before: Tuple = ()


class Schedule:
    def __init__(self, label: str):
        self.label = label
        self.entries: List[SystemEntry] = []
        self.set_entries: Dict[str, SetEntry] = {}
        self._order: Optional[List[SystemEntry]] = None

    def configure_set(self, name: str, after=(), before=()):
        self.set_entries[name] = SetEntry(name, _tup(after), _tup(before))
        self._order = None

    def add_systems(self, systems, after=(), before=(), chain=False,
                    in_set=None):
        sys_list = list(systems) if isinstance(systems, (list, tuple)) \
            else [systems]
        for s in sys_list:
            if not isinstance(s, System):
                raise TypeError(f"{s!r} is not a System (forgot @system?)")
        sets = (in_set,) if in_set else ()
        prev = None
        for s in sys_list:
            entry_after = _tup(after)
            if chain and prev is not None:
                entry_after = entry_after + (prev,)
            self.entries.append(SystemEntry(s, entry_after, _tup(before), sets))
            prev = s
        self._order = None
        return self

    def _resolve(self, target) -> List[int]:
        """Entry indices matching a before/after target (System, system
        name, or set name)."""
        return [i for i, e in enumerate(self.entries)
                if target is e.system or target == e.system.name
                or target in e.sets]

    def build_order(self) -> List[SystemEntry]:
        if self._order is not None:
            return self._order
        n = len(self.entries)
        edges = [set() for _ in range(n)]   # edges[i] = js that run after i
        indeg = [0] * n

        def add_edge(a, b):
            if b not in edges[a]:
                edges[a].add(b)
                indeg[b] += 1

        for i, e in enumerate(self.entries):
            targets_after = list(e.after)
            targets_before = list(e.before)
            for sname in e.sets:
                se = self.set_entries.get(sname)
                if se is not None:
                    targets_after += list(se.after)
                    targets_before += list(se.before)
            for t in targets_after:
                for j in self._resolve(t):
                    if j != i:
                        add_edge(j, i)
            for t in targets_before:
                for j in self._resolve(t):
                    if j != i:
                        add_edge(i, j)

        ready = [i for i in range(n) if indeg[i] == 0]
        order = []
        while ready:
            i = min(ready)
            ready.remove(i)
            order.append(i)
            for j in edges[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != n:
            cyc = [self.entries[i].system.name for i in range(n)
                   if i not in order]
            raise RuntimeError(f"schedule '{self.label}': dependency cycle "
                               f"among {cyc}")
        self._order = [self.entries[i] for i in order]
        return self._order

    def init_systems(self, world):
        for e in self.entries:
            e.system.init_state(world)

    def run(self, state, world):
        """Run every system in order against `state`; returns the new state."""
        for e in self.build_order():
            state = e.system.run(state, world)
        return state


def _tup(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) if x else ()
