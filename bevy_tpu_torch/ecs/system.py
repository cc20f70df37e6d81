"""Systems (port of bevy_tpu/ecs/system.py; ref: bevy_ecs function systems,
`system/function_system.rs`; access sets `query/access.rs`).

A system is a plain function whose default argument values declare its
params (Query / Res / ResMut / Commands / Local / MessageWriter /
MessageReader / Trigger / On / LifecycleMask, and any type added with
`register_param_type`, such as render Gizmos)::

    @system
    def apply_velocity(q=Query(Transform, Read(Velocity)), time=Res(Time)):
        q.transform.translation = q.transform.translation + \\
            q.velocity.value * time.delta

The body runs eagerly on the world's device; staged writes merge
afterwards and the world tick advances (ref: system ticks). `host=True`
(or `host_system`) marks a system the App runs against `world.state`
directly, between the device items; it may take the World as `world`.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.commands import Commands
from bevy_tpu_torch.ecs.message import MessageReader, MessageWriter
from bevy_tpu_torch.ecs.observer import LifecycleMask, On, Trigger
from bevy_tpu_torch.ecs.query import Local, Query, Res

PARAM_TYPES = (Query, Res, Commands, Local, MessageWriter, MessageReader,
               Trigger, On, LifecycleMask)


def register_param_type(cls):
    """Extend the accepted system-param set (used by e.g. render Gizmos).
    A param type has `build(state, world, sysctx)`, returning a view whose
    `merge(state, tick)` returns the new state after the body."""
    global PARAM_TYPES
    PARAM_TYPES = PARAM_TYPES + (cls,)


class System:
    _counter = 0

    def __init__(self, fn: Callable, host: bool = False,
                 name: Optional[str] = None):
        self.fn = fn
        self.host = host
        self.name = name or fn.__name__
        System._counter += 1
        self.id = f"{self.name}#{System._counter}"
        self.params: Dict[str, object] = {}
        self.wants_world = False
        for pname, p in inspect.signature(fn).parameters.items():
            if pname == "world" and p.default is inspect.Parameter.empty:
                # host systems may take the World itself (ref: exclusive
                # systems with &mut World)
                if not host:
                    raise TypeError(f"system {self.name}: 'world' param "
                                    f"requires host=True")
                self.wants_world = True
            elif isinstance(p.default, PARAM_TYPES):
                self.params[pname] = p.default
                if isinstance(p.default, Local):
                    p.default.param_name = pname
            else:
                raise TypeError(f"system {self.name}: parameter '{pname}' has "
                                f"no param declaration (use e.g. "
                                f"{pname}=Query(...))")
        self.reads, self.writes = set(), set()
        for p in self.params.values():
            self.reads |= p.reads() if hasattr(p, "reads") else set()
            self.writes |= p.writes() if hasattr(p, "writes") else set()
        self.has_commands = any(isinstance(p, Commands)
                                for p in self.params.values())

    def conflicts_with(self, other: "System") -> set:
        """Access conflicts (ref: FilteredAccessSet::get_conflicts)."""
        return (self.writes & (other.reads | other.writes)) | \
            (self.reads & other.writes)

    def init_state(self, world):
        """Ensure per-system state + queried storage exist before a run."""
        for p in self.params.values():
            if isinstance(p, Query):
                # a Removed filter's component gets no storage here (as
                # the reference's: its query raises until one registers it)
                for spec in (*p.comps, *p.with_, *p.without, *p.changed,
                             *p.added):
                    world.register_component(spec)
            elif isinstance(p, Commands):
                for spec in p.spawn_comps:
                    world.register_component(spec)
            elif isinstance(p, LifecycleMask):
                world.register_component(p.trigger.spec)
        if self.id not in world.state["sys"]:
            dev = world.device
            local = {pname: _local_tensors(p.default, dev)
                     for pname, p in self.params.items()
                     if isinstance(p, Local)}
            world.state["sys"][self.id] = {
                "last_run": torch.tensor(0, dtype=torch.int32, device=dev),
                "local": local}
            world.structure_version += 1

    def call(self, state, world):
        """Build the params, run the body; returns the views, or None when
        the body failed and the world's error handler took the error (ref:
        Result-returning systems, bevy_ecs/src/error/handler.rs; without a
        handler the error is raised)."""
        sysctx = {"id": self.id}
        views = {pname: p.build(state, world, sysctx)
                 for pname, p in self.params.items()}
        handler = getattr(world, "error_handler", None)
        try:
            with record_function(f"system:{self.name}"):
                result = self.fn(world, **views) if self.wants_world \
                    else self.fn(**views)
        except Exception as e:  # noqa: BLE001 — routed, not swallowed
            if handler is None:
                raise
            handler(e, self)
            return None
        if isinstance(result, Exception):
            if handler is None:
                raise result
            handler(result, self)
            return None
        return views

    def run(self, state, world):
        """Run the system against a state dict, returning the new state:
        staged writes merge, `last_run` takes the tick and the tick
        advances. A failed body (routed to the handler) leaves `state`."""
        views = self.call(state, world)
        if views is None:
            return state
        tick = state["tick"]
        for view in views.values():
            state = view.merge(state, tick)
        state = set_in(state, ("sys", self.id, "last_run"), tick)
        return set_in(state, ("tick",), tick + 1)

    def __repr__(self):
        return f"System({self.name})"


def _local_tensors(default, dev):
    if isinstance(default, dict):
        return {k: torch.as_tensor(v, device=dev) for k, v in default.items()}
    return torch.as_tensor(default, device=dev)


def system(fn=None, *, host=False, name=None):
    """Decorator turning a function into a System."""

    def wrap(f):
        return System(f, host=host, name=name)

    return wrap(fn) if fn is not None else wrap


def host_system(fn=None, **kw):
    return system(fn, host=True, **kw)
