"""Schedules (port of bevy_tpu/ecs/schedule.py; ref: bevy_ecs schedule/ —
build_schedule topsort + ambiguity detection `schedule.rs:1222,1357`).

Order is explicit `before`/`after` edges (to systems, names or set names),
set-level ordering from `configure_set`, and chained tuples —
topologically sorted with stable insertion order (Kahn), cycle check
included. Unordered pairs whose accesses conflict are listed in
`ambiguities` (ref: ambiguity detection; a lint, nothing is reordered).
Systems then run one after another, eagerly.

Run conditions (`run_if`: one condition system or a tuple, ANDed) gate a
device system by predication: its body runs, and the new state is taken
leaf by leaf where the condition's device bool holds, else the old one —
exactly the false branch of the reference's `lax.cond` (no tick advance,
no `last_run` or `changed` stamp), and no host read. A host system's
conditions are read on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from bevy_tpu_torch.ecs._state import select_tree, set_in
from bevy_tpu_torch.ecs.system import System


@dataclass
class SystemEntry:
    system: System
    after: Tuple = ()
    before: Tuple = ()
    run_if: Optional[object] = None
    sets: Tuple[str, ...] = ()


class ScheduleAmbiguity(Warning):
    """An unordered pair of systems with conflicting access (listed in
    `Schedule.ambiguities`)."""


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
        self.ambiguities: List[Tuple[str, str, set]] = []

    def configure_set(self, name: str, after=(), before=()):
        self.set_entries[name] = SetEntry(name, _tup(after), _tup(before))
        self._order = None

    def add_systems(self, systems, after=(), before=(), chain=False,
                    run_if=None, in_set=None):
        sys_list = list(systems) if isinstance(systems, (list, tuple)) \
            else [systems]
        for s in sys_list:
            if not isinstance(s, System):
                raise TypeError(f"{s!r} is not a System (forgot @system?)")
        sets = (in_set,) if in_set else ()
        # chained conditions AND together (ref: .run_if(a).run_if(b))
        if isinstance(run_if, (list, tuple)):
            run_if = tuple(run_if) or None
        prev = None
        for s in sys_list:
            entry_after = _tup(after)
            if chain and prev is not None:
                entry_after = entry_after + (prev,)
            self.entries.append(SystemEntry(s, entry_after, _tup(before),
                                            run_if, sets))
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
        self._detect_ambiguities(edges, order)
        return self._order

    def _detect_ambiguities(self, edges, order):
        """Unordered pairs with conflicting access (ref:
        schedule.rs:1357-1390)."""
        n = len(self.entries)
        reach = [set() for _ in range(n)]
        for i in reversed(order):
            for j in edges[i]:
                reach[i].add(j)
                reach[i] |= reach[j]
        self.ambiguities = []
        for a in range(n):
            for b in range(a + 1, n):
                if b in reach[a] or a in reach[b]:
                    continue
                conflict = self.entries[a].system.conflicts_with(
                    self.entries[b].system)
                if conflict:
                    self.ambiguities.append((self.entries[a].system.name,
                                             self.entries[b].system.name,
                                             conflict))

    def init_systems(self, world):
        for e in self.entries:
            e.system.init_state(world)
            for c in _conds(e.run_if):
                c.init_state(world)

    def items(self):
        return self.build_order()

    def run(self, state, world):
        """Run every device system in order against `state`; returns the new
        state. Host systems belong to the App's frame."""
        for e in self.build_order():
            if e.system.host:
                raise RuntimeError(f"host system '{e.system.name}' cannot run "
                                   f"inside Schedule.run; the App runs it")
            state = run_entry(e, state, world)
        return state


def _conds(run_if):
    """A run_if spec (None | System | tuple) as a tuple."""
    if run_if is None:
        return ()
    return run_if if isinstance(run_if, tuple) else (run_if,)


def _eval_condition(cond: System, state, world):
    sysctx = {"id": cond.id}
    views = {pname: p.build(state, world, sysctx)
             for pname, p in cond.params.items()}
    return cond.fn(**views)


def condition(entry: SystemEntry, state, world):
    """The AND of an entry's run conditions (a device bool or a Python
    bool); None without conditions."""
    conds = _conds(entry.run_if)
    if not conds:
        return None
    pred = _eval_condition(conds[0], state, world)
    for c in conds[1:]:
        pred = pred & _eval_condition(c, state, world)
    return pred


def run_predicated(pred, fn, state):
    """`fn(state)` where the device bool `pred` holds, else `state`, leaf by
    leaf (the predicated `lax.cond(pred, fn, identity, state)`). A Python
    bool picks on the host."""
    if not isinstance(pred, torch.Tensor):
        return fn(state) if pred else state
    return select_tree(pred, fn(state), state)


def run_entry(entry: SystemEntry, state, world):
    """Run one device entry under its conditions."""
    pred = condition(entry, state, world)
    if pred is None:
        return entry.system.run(state, world)
    return run_predicated(pred, lambda s: entry.system.run(s, world), state)


def run_host_entry(entry: SystemEntry, world):
    """Run one host system against world.state (ref: exclusive systems).
    Its conditions are read on the host; the body may edit the world's
    structure, and its staged writes merge into the state it leaves."""
    for cond in _conds(entry.run_if):
        if not bool(_eval_condition(cond, world.state, world)):
            return
    views = entry.system.call(world.state, world)
    if views is None:
        return
    state = world.state
    tick = state["tick"]
    for view in views.values():
        state = view.merge(state, tick)
    state = set_in(state, ("sys", entry.system.id, "last_run"), tick)
    world.state = set_in(state, ("tick",), tick + 1)


def _tup(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) if x else ()
