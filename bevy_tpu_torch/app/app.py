"""App (port of bevy_tpu/app/app.py; ref: bevy_app app.rs:85 — App + headless
runner, Main schedule order main_schedule.rs:57-200).

Execution model: the ordered systems of every schedule in Main order
(plus ExtractSchedule and Render) form one list of *run items*, and a
frame runs them eagerly, one after another, on the world's device. There
is no jit: `frame_fn()` returns that list as a plain `step(state) ->
state` function. Per-frame input (dt) enters as a device fill, so a frame
with no fixed-timestep systems needs no host↔device synchronisation.
"""

from __future__ import annotations

import time as _pytime
from typing import Dict, List, Optional

import torch

from bevy_tpu_torch.app.main_schedule import (
    FIXED_MAIN_ORDER, MAIN_ORDER, STARTUP_ORDER, RunFixedMainLoop,
    ExtractSchedule, Render,
)
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import ComponentInstance, get_spec
from bevy_tpu_torch.ecs.message import swap_message_buffers
from bevy_tpu_torch.ecs.schedule import Schedule
from bevy_tpu_torch.ecs.world import World


class App:
    def __init__(self, capacity: int = World.DEFAULT_CAPACITY,
                 device="cuda"):
        self.world = World(capacity, device)
        self.schedules: Dict[str, Schedule] = {}
        self.main_order = list(MAIN_ORDER)
        self.startup_order = list(STARTUP_ORDER)
        self.fixed_order = list(FIXED_MAIN_ORDER)
        self._plugins: List[Plugin] = []
        self._plugin_names = set()
        self._started = False
        self._prepare_hooks: List = []
        self._prepare_versions: List[int] = []
        self.max_fixed_steps_per_frame = 8  # safety clamp alongside max_delta
        self.time_strategy: Optional[float] = None  # None = wall clock
        self._last_wall: Optional[float] = None

    @property
    def device(self):
        return self.world.device

    # ------------------------------------------------------------------
    # building

    def schedule(self, label) -> Schedule:
        if label not in self.schedules:
            self.schedules[label] = Schedule(label)
        return self.schedules[label]

    def add_systems(self, label, systems, *more, **cfg):
        """ref: App::add_systems — one system, a list/tuple, or varargs."""
        if more:
            systems = [systems, *more]
        self.schedule(label).add_systems(systems, **cfg)
        return self

    def configure_set(self, label, name, **cfg):
        self.schedule(label).configure_set(name, **cfg)
        return self

    def add_plugins(self, *plugins):
        for p in plugins:
            if isinstance(p, (list, tuple)):
                self.add_plugins(*p)
                continue
            if isinstance(p, type):
                p = p()
            if not isinstance(p, Plugin):
                raise TypeError(f"not a plugin: {p!r}")
            if p.name in self._plugin_names:
                continue
            self._plugin_names.add(p.name)
            self._plugins.append(p)
            p.build(self)
        return self

    def insert_resource(self, res, value=None):
        """Insert/overwrite a resource (ref: App::insert_resource)."""
        self.world.insert_resource(res, value)
        return self

    def init_resource(self, res_or_instance):
        """Insert only if absent (ref: App::init_resource)."""
        inst = res_or_instance if isinstance(res_or_instance,
                                             ComponentInstance) \
            else res_or_instance()
        if get_spec(inst).name not in self.world.state["res"]:
            self.world.insert_resource(inst)
        return self

    def add_message(self, msg, capacity: int = 1024):
        """Register a buffered message type (ref: App::add_message)."""
        self.world.add_message(msg, capacity)
        return self

    def add_prepare_hook(self, fn):
        """Host callback run before a frame whenever world structure
        changed since its last run (ref position: PrepareMeshes)."""
        self._prepare_hooks.append(fn)
        self._prepare_versions.append(-1)
        return self

    # ------------------------------------------------------------------
    # run items

    def _items(self, labels, include_frame_end):
        items = [("frame_begin",)] if include_frame_end else []
        for label in labels:
            sched = self.schedules.get(label)
            if sched is not None:
                sched.init_systems(self.world)
                items += [("sys", e.system) for e in sched.build_order()]
            if label == RunFixedMainLoop:
                for fl in self.fixed_order:
                    if fl in self.schedules:
                        self.schedules[fl].init_systems(self.world)
                items.append(("fixed",))
        if include_frame_end:
            items.append(("frame_end",))
        return items

    def _thunk(self, item):
        """Thunks are (state, dt) -> state."""
        world = self.world
        if item[0] == "sys":
            return lambda state, dt: item[1].run(state, world)
        if item[0] == "fixed":
            return lambda state, dt: self._fixed_loop(state)
        if item[0] == "frame_begin":
            def frame_begin(state, dt):
                if "frame_input" not in state["res"]:
                    return state
                store = dict(state["res"]["frame_input"])
                store["dt"] = torch.full((), dt, dtype=torch.float32,
                                         device=world.device)
                return set_in(state, ("res", "frame_input"), store)
            return frame_begin
        if item[0] == "frame_end":
            return lambda state, dt: set_in(swap_message_buffers(state),
                                            ("frame",), state["frame"] + 1)
        raise ValueError(item)

    # ------------------------------------------------------------------
    # fixed main loop (ref: run_fixed_main_schedule, bevy_time fixed.rs:243)

    def _fixed_loop(self, state):
        if "time_fixed" not in state["res"]:
            return state
        scheds = [self.schedules[lb] for lb in self.fixed_order
                  if lb in self.schedules and self.schedules[lb].entries]
        if not scheds:
            # no fixed system observes the clock mid-loop: drain the
            # accumulator with the reference's step-by-step subtraction,
            # unrolled and masked, so the frame never waits on the device
            tf = state["res"]["time_fixed"]
            ts, over, el = tf["timestep"], tf["overstep"], tf["elapsed"]
            for _ in range(self.max_fixed_steps_per_frame):
                go = over >= ts
                over = torch.where(go, over - ts, over)
                el = torch.where(go, el + ts, el)
            return set_in(state, ("res", "time_fixed"),
                          {"timestep": ts, "overstep": over, "elapsed": el})
        for _ in range(self.max_fixed_steps_per_frame):
            tf = state["res"]["time_fixed"]
            ts = tf["timestep"]
            if not bool(tf["overstep"] >= ts):     # host sync per fixed step
                break
            state = set_in(state, ("res", "time_fixed"), {
                "timestep": ts, "overstep": tf["overstep"] - ts,
                "elapsed": tf["elapsed"] + ts})
            # generic Time becomes the fixed clock inside FixedMain
            if "time" in state["res"]:
                t = dict(state["res"]["time"])
                t["delta"] = ts
                t["elapsed"] = state["res"]["time_fixed"]["elapsed"]
                state = set_in(state, ("res", "time"), t)
            for sched in scheds:
                state = sched.run(state, self.world)
        # restore the generic clock to virtual time
        if "time" in state["res"] and "time_virtual" in state["res"]:
            tv = state["res"]["time_virtual"]
            t = dict(state["res"]["time"])
            t["delta"] = tv["delta"]
            t["elapsed"] = tv["elapsed"]
            state = set_in(state, ("res", "time"), t)
        return state

    # ------------------------------------------------------------------
    # running

    def startup(self):
        if self._started:
            return
        self._started = True
        for p in self._plugins:
            p.finish(self)
        for t in [self._thunk(it) for it in self._items(self.startup_order,
                                                         False)]:
            self.world.state = t(self.world.state, 0.0)

    def _run_prepare_hooks(self):
        for k, fn in enumerate(self._prepare_hooks):
            if self._prepare_versions[k] != self.world.structure_version:
                fn(self.world)
                self._prepare_versions[k] = self.world.structure_version

    def _frame_dt(self) -> float:
        if self.time_strategy is not None:
            return float(self.time_strategy)
        now = _pytime.perf_counter()
        if self._last_wall is None:
            self._last_wall = now
            return 1.0 / 60.0
        dt = now - self._last_wall
        self._last_wall = now
        return dt

    def frame_fn(self):
        """The whole frame as one plain function `step(state, dt=1/60) ->
        state`, run eagerly (what benchmarks and chip_smoke.py time)."""
        self.startup()
        self._run_prepare_hooks()
        order = list(self.main_order)
        for label in (ExtractSchedule, Render):
            if label in self.schedules and label not in order:
                order.append(label)
        thunks = [self._thunk(it) for it in self._items(order, True)]

        def step(state, dt=1.0 / 60.0):
            for t in thunks:
                state = t(state, dt)
            return state

        return step

    def update(self, dt: Optional[float] = None):
        """One frame (ref: SubApps::update)."""
        step = self.frame_fn()
        dt = self._frame_dt() if dt is None else float(dt)
        self.world.state = step(self.world.state, dt)

    def run(self, max_frames: int, dt: Optional[float] = None):
        """Headless loop (ref: ScheduleRunnerPlugin::run_loop)."""
        for _ in range(max_frames):
            self.update(dt)
        return self

    @property
    def frame(self) -> int:
        return int(self.world.state["frame"])
