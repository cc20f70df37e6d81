"""States (port of bevy_tpu/state.py; ref: bevy_state — States resources,
the StateTransition schedule running OnExit / OnEnter schedules
`src/state/freely_mutable_state.rs:29-62`, `StateScoped` cleanup,
`in_state` run conditions `src/condition.rs`).

A state is an int32 resource {current, next, prev, exists}. Its
transition system runs EVERY OnExit / OnEnter schedule of the machine
predicated on `changed & (value == v)` (ecs/schedule.run_predicated): each
body runs and its new state is kept only where the device bool holds —
the false branch leaves tick, `last_run` and `changed` as they were, as
the reference's `lax.cond`, and the frame reads nothing back.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.app.main_schedule import ScheduleLabel, StateTransition
from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.commands import _apply_despawn
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Res, ResMut
from bevy_tpu_torch.ecs.schedule import SystemEntry, run_predicated
from bevy_tpu_torch.ecs.system import System, system

_STATE_IDS: dict = {}


@component
class StateScoped:
    """Entities despawned when their state value is exited (ref:
    StateScoped, bevy_state/src/state_scoped.rs); made by `state_scoped`."""
    state_id = field((), torch.int32)
    value = field((), torch.int32)


def state_scoped(state_name: str, value: int):
    return StateScoped(state_id=_STATE_IDS[state_name], value=int(value))


def OnEnter(state_name: str, value: int) -> ScheduleLabel:
    """Schedule label run when `state_name` enters `value` (ref: OnEnter)."""
    return ScheduleLabel(f"OnEnter({state_name},{int(value)})")


def OnExit(state_name: str, value: int) -> ScheduleLabel:
    return ScheduleLabel(f"OnExit({state_name},{int(value)})")


def _state_res(app, state_name, initial, exists):
    if state_name not in _STATE_IDS:
        _STATE_IDS[state_name] = len(_STATE_IDS)
    dev = app.world.device

    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=dev)

    app.insert_resource(f"state_{state_name}", {
        "current": i32(initial), "next": i32(-1), "prev": i32(initial),
        "exists": torch.tensor(bool(exists), device=dev)})


class _TransitionSystem(System):
    """OnExit(current) then OnEnter(next), predicated (ref:
    apply_state_transition). Like the reference's, its own run neither
    advances the tick nor stamps a last_run."""

    def __init__(self, app, state_name: str, values):
        super().__init__(lambda: None,
                         name=f"apply_state_transition_{state_name}")
        self.app = app
        self.state_name = state_name
        self.values = list(values)
        # StateScoped cleanup despawns: the host mirrors go stale
        self.has_commands = True

    def init_state(self, world):
        super().init_state(world)
        for v in self.values:
            for label in (OnEnter(self.state_name, v),
                          OnExit(self.state_name, v)):
                if label in self.app.schedules:
                    self.app.schedules[label].init_systems(world)

    def _labels(self, kind, state, world, pred_of):
        """Run every non-empty OnExit / OnEnter schedule of the machine,
        each predicated on pred_of(v)."""
        for v in self.values:
            sched = self.app.schedules.get(kind(self.state_name, v))
            if sched is not None and sched.entries:
                state = run_predicated(
                    pred_of(v), lambda s, sc=sched: sc.run(s, world), state)
        return state

    def _scoped_cleanup(self, state, world, when, value):
        """StateScoped cleanup on exit (ref: clear_state_scoped_entities)."""
        if "state_scoped" not in state["comp"]:
            return state
        ss = state["comp"]["state_scoped"]
        doomed = when & ss["has"] & \
            (ss["f"]["state_id"] == _STATE_IDS[self.state_name]) & \
            (ss["f"]["value"] == value)
        world.mark_device_dirty()
        return _apply_despawn(state, doomed)

    def run(self, state, world):
        rname = f"state_{self.state_name}"
        cur = state["res"][rname]["current"]
        nxt = state["res"][rname]["next"]
        changed = (nxt >= 0) & (nxt != cur)
        # the pre-transition value, for sub-states (ref: the transition
        # event's `exited`)
        state = set_in(state, ("res", rname, "prev"), cur)
        state = self._scoped_cleanup(state, world, changed, cur)
        state = self._labels(OnExit, state, world,
                             lambda v: changed & (cur == v))
        state = self._labels(OnEnter, state, world,
                             lambda v: changed & (nxt == v))
        state = set_in(state, ("res", rname, "current"),
                       torch.where(changed, nxt, cur))
        return set_in(state, ("res", rname, "next"), torch.full_like(nxt, -1))


def add_state(app, state_name: str, initial: int, values):
    """Register a state machine (ref: App::init_state)."""
    _state_res(app, state_name, initial, True)
    app.world.register_component(StateScoped)
    app.schedule(StateTransition).entries.append(
        SystemEntry(_TransitionSystem(app, state_name, values)))
    return app


class _SubStateSystem(_TransitionSystem):
    """A child machine alive only while parent == parent_value (ref:
    SubStates): re-initialised on parent entry (OnEnter(initial)), torn
    down on parent exit (OnExit(current)), its own transitions while
    active."""

    def __init__(self, app, state_name, values, initial, parent,
                 parent_value):
        super().__init__(app, state_name, values)
        self.initial = int(initial)
        self.parent = parent
        self.parent_value = int(parent_value)

    def run(self, state, world):
        rname = f"state_{self.state_name}"
        pres = state["res"][f"state_{self.parent}"]
        active = pres["current"] == self.parent_value
        was = pres["prev"] == self.parent_value
        entered = active & ~was
        exited = ~active & was
        cur = state["res"][rname]["current"]
        nxt = state["res"][rname]["next"]
        own = active & (nxt >= 0) & (nxt != cur)
        state = self._scoped_cleanup(state, world, exited | own, cur)
        state = self._labels(OnExit, state, world,
                             lambda v: (exited | own) & (cur == v))
        # parent entry re-initialises; own transitions pick `next`
        target = torch.where(entered, torch.full_like(nxt, self.initial), nxt)
        fire_enter = entered | own
        state = self._labels(OnEnter, state, world,
                             lambda v: fire_enter & (target == v))
        state = set_in(state, ("res", rname, "prev"), cur)
        state = set_in(state, ("res", rname, "current"),
                       torch.where(fire_enter, target, cur))
        state = set_in(state, ("res", rname, "next"), torch.full_like(nxt, -1))
        return set_in(state, ("res", rname, "exists"), active)


def add_sub_state(app, state_name: str, initial: int, values,
                  parent: str, parent_value: int):
    """Register a sub-state machine (ref: App::add_sub_state), AFTER
    add_state(parent), so the parent's transition applies first."""
    _state_res(app, state_name, initial, False)
    app.schedule(StateTransition).entries.append(SystemEntry(
        _SubStateSystem(app, state_name, values, initial, parent,
                        parent_value)))
    return app


class NextState(ResMut):
    """ResMut param requesting a transition (ref: NextState<S>)::

        ns = NextState('app_state'); ns.set(GameState.PLAYING)
    """

    def __init__(self, state_name: str):
        super().__init__(f"state_{state_name}")

    def build(self, state, world, sysctx):
        view = super().build(state, world, sysctx)

        def set_value(v):
            view.next = torch.as_tensor(v, dtype=torch.int32,
                                        device=world.device)
        object.__setattr__(view, "set", set_value)
        return view


class CurrentState(Res):
    """Read-only current state value (ref: State<S>)."""

    def __init__(self, state_name: str):
        super().__init__(f"state_{state_name}")


class _ComputedStateSystem(_TransitionSystem):
    """A state derived from others every frame (ref: ComputedStates):
    `compute({name: current})` returns a device int; OnEnter / OnExit fire
    on change."""

    def __init__(self, app, state_name, values, sources, compute):
        super().__init__(app, state_name, values)
        self.sources = list(sources)
        self.compute = compute

    def run(self, state, world):
        rname = f"state_{self.state_name}"
        cur = state["res"][rname]["current"]
        srcs = {s: state["res"][f"state_{s}"]["current"]
                for s in self.sources}
        new = torch.as_tensor(self.compute(srcs), dtype=torch.int32,
                              device=cur.device)
        changed = new != cur
        state = self._scoped_cleanup(state, world, changed, cur)
        state = self._labels(OnExit, state, world,
                             lambda v: changed & (cur == v))
        state = self._labels(OnEnter, state, world,
                             lambda v: changed & (new == v))
        state = set_in(state, ("res", rname, "prev"), cur)
        return set_in(state, ("res", rname, "current"), new)


def add_computed_state(app, state_name: str, values, sources, compute,
                       initial: int = 0):
    """Register a derived state (ref: App::add_computed_state); its
    sources' transition systems must be added first."""
    _state_res(app, state_name, initial, True)
    app.schedule(StateTransition).entries.append(SystemEntry(
        _ComputedStateSystem(app, state_name, values, sources, compute)))
    return app


def in_state(state_name: str, value: int) -> System:
    """Run condition (ref: in_state); false while a sub-state's parent is
    elsewhere (`exists`)."""

    @system(name=f"in_state_{state_name}_{value}")
    def cond(s=Res(f"state_{state_name}")):
        return s.exists & (s.current == value)

    return cond
