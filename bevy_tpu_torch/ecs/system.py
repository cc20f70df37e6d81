"""Systems (port of bevy_tpu/ecs/system.py; ref: bevy_ecs function systems).

A system is a plain function whose default argument values declare its
params (Query / Res / ResMut / Commands / MessageWriter / MessageReader,
and any type added with `register_param_type`, such as render Gizmos)::

    @system
    def apply_velocity(q=Query(Transform, Read(Velocity)), time=Res(Time)):
        q.transform.translation = q.transform.translation + \\
            q.velocity.value * time.delta

The body runs eagerly on the world's device; staged writes merge
afterwards and the world tick advances (ref: system ticks).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.commands import Commands
from bevy_tpu_torch.ecs.message import MessageReader, MessageWriter
from bevy_tpu_torch.ecs.query import Query, Res

PARAM_TYPES = (Query, Res, Commands, MessageWriter, MessageReader)


def register_param_type(cls):
    """Extend the accepted system-param set (used by e.g. render Gizmos).
    A param type has `build(state, world, sysctx)`, returning a view whose
    `merge(state, tick)` returns the new state after the body."""
    global PARAM_TYPES
    PARAM_TYPES = PARAM_TYPES + (cls,)


class System:
    _counter = 0

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.name = name or fn.__name__
        System._counter += 1
        self.id = f"{self.name}#{System._counter}"
        self.params: Dict[str, object] = {}
        for pname, p in inspect.signature(fn).parameters.items():
            if not isinstance(p.default, PARAM_TYPES):
                raise TypeError(f"system {self.name}: parameter '{pname}' has "
                                f"no param declaration (use e.g. "
                                f"{pname}=Query(...))")
            self.params[pname] = p.default

    def init_state(self, world):
        """Ensure per-system state + queried storage exist before a run."""
        for p in self.params.values():
            if isinstance(p, Query):
                for spec in p.specs():
                    world.register_component(spec)
            elif isinstance(p, Commands):
                for spec in p.spawn_comps:
                    world.register_component(spec)
        if self.id not in world.state["sys"]:
            world.state["sys"][self.id] = {
                "last_run": torch.tensor(0, dtype=torch.int32,
                                         device=world.device)}
            world.structure_version += 1

    def run(self, state, world):
        """Run the system against a state dict, returning the new state.
        The body runs in a `system:<name>` profiler span."""
        sysctx = {"id": self.id}
        views = {pname: p.build(state, world, sysctx)
                 for pname, p in self.params.items()}
        with record_function(f"system:{self.name}"):
            self.fn(**views)
        tick = state["tick"]
        for view in views.values():
            state = view.merge(state, tick)
        state = set_in(state, ("sys", self.id, "last_run"), tick)
        return set_in(state, ("tick",), tick + 1)

    def __repr__(self):
        return f"System({self.name})"


def system(fn=None, *, name=None):
    """Decorator turning a function into a System."""

    def wrap(f):
        return System(f, name=name)

    return wrap(fn) if fn is not None else wrap
