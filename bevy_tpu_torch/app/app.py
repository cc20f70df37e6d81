"""App (port of bevy_tpu/app/app.py; ref: bevy_app app.rs:85 — App + headless
runner, Main schedule order main_schedule.rs:57-200).

Execution model: the ordered systems of every schedule in Main order
(plus ExtractSchedule and Render) form one list of *run items*, and a
frame runs them eagerly, one after another, on the world's device. There
is no jit: `frame_fn()` returns that list as a plain `step(state) ->
state` function (host systems refused, as the reference's). Per-frame
input enters at frame start: dt as a device fill, the registered input
channels (`register_frame_input`) as one host-to-device copy, so a frame
with no fixed-timestep system and no host system reads nothing back.
Host systems (`system(host=True)`) run between the device items against
`world.state`, in `update()`. Observers are spliced statically: event
observers after the last system of each schedule that triggers their
event, lifecycle observers after frame start and after every item that
holds Commands.
"""

from __future__ import annotations

import time as _pytime
from typing import Dict, List, Optional

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import (
    FIXED_MAIN_ORDER, MAIN_ORDER, STARTUP_ORDER, RunFixedMainLoop,
    ExtractSchedule, Render,
)
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import ComponentInstance, field, get_spec
from bevy_tpu_torch.ecs.message import message, swap_message_buffers
from bevy_tpu_torch.ecs.observer import (
    LifecycleTrigger, Trigger, clear_observer_buffers, register_event_storage,
)
from bevy_tpu_torch.ecs.schedule import (
    Schedule, SystemEntry, run_entry, run_host_entry,
)
from bevy_tpu_torch.ecs.world import World


# 64-bit host values enter as the 32-bit types of the state (as JAX's
# default x64-off conversion does)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


@message
class AppExit:
    """Exit request (ref: AppExit message, bevy_app/src/app.rs)."""
    code = field((), torch.int32)


def pack_frame_input(values, device):
    """One host-to-device copy of a frame's input channels: each numpy
    array laid into a byte buffer at a 4-byte aligned offset, copied once,
    and viewed back per channel with its dtype and shape."""
    arrs = {k: np.array(v, order="C") for k, v in values.items()}
    offs, n = {}, 0
    for k, a in arrs.items():
        offs[k] = n
        n += -(-a.nbytes // 4) * 4
    buf = np.zeros(max(n, 4), np.uint8)
    for k, a in arrs.items():
        buf[offs[k]:offs[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out = {}
    for k, a in arrs.items():
        dt = {np.dtype(np.bool_): torch.bool, np.dtype(np.float32):
              torch.float32, np.dtype(np.int32): torch.int32}[a.dtype]
        out[k] = dev[offs[k]:offs[k] + a.nbytes].view(dt).reshape(a.shape)
    return out


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
        # host -> device input channels: name -> fn() giving a fixed-shape
        # numpy array, copied in at every frame start
        self._input_channels: Dict[str, object] = {}
        self._observers: Dict[str, List[SystemEntry]] = {}
        self._lifecycle_observers: List[SystemEntry] = []
        self._frame_hooks: List = []
        self._one_shot: List = []
        self.max_fixed_steps_per_frame = 8  # safety clamp alongside max_delta
        self.time_strategy: Optional[float] = None  # None = wall clock
        self._last_wall: Optional[float] = None
        self.world.add_message(AppExit, capacity=4)

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
        """ref: App::add_systems — one system, a list/tuple, or varargs;
        `run_if`, `after`, `before`, `chain`, `in_set` as Schedule's."""
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

    def is_plugin_added(self, name: str) -> bool:
        return name in self._plugin_names

    def set_error_handler(self, handler):
        """Route system errors (ref: App::set_error_handler,
        bevy_ecs/src/error/handler.rs): `handler(exc, system)` takes what a
        system body raises or returns as an Exception, and that system's
        staged writes are dropped. None restores the default (raise);
        "warn" logs and goes on, "ignore" goes on. Bodies run eagerly, so
        the handler hears a failing system every frame (the reference's
        device systems fail once, when traced)."""
        if handler == "warn":
            import logging

            def handler(e, sys_):  # noqa: F811
                logging.getLogger("bevy_tpu_torch").warning(
                    "system %s failed: %s", sys_.name, e)
        elif handler == "ignore":
            def handler(e, sys_):  # noqa: F811
                pass
        self.world.error_handler = handler
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

    def add_observer(self, ev, observer_system, capacity: int = 64):
        """Register a push reaction to an event (ref: App::add_observer).
        The observer runs in every schedule that holds a system with a
        Trigger(ev) param, right after that schedule's systems. `ev` may be
        a lifecycle trigger, OnAdd(C) / OnInsert(C) / OnRemove(C): such an
        observer runs after frame start and after every Commands-bearing
        item, and sees only what happens after this call."""
        if isinstance(ev, LifecycleTrigger):
            observer_system.init_state(self.world)
            self.world.state["sys"][observer_system.id]["last_run"] = \
                self.world.state["tick"].clone()
            self._lifecycle_observers.append(SystemEntry(observer_system))
            return self
        spec = register_event_storage(self.world, ev, capacity)
        self._observers.setdefault(spec.name, []).append(
            SystemEntry(observer_system))
        return self

    def add_prepare_hook(self, fn):
        """Host callback run before a frame whenever world structure
        changed since its last run (ref position: PrepareMeshes)."""
        self._prepare_hooks.append(fn)
        self._prepare_versions.append(-1)
        return self

    def add_frame_hook(self, fn):
        """Host callback after each update (diagnostics, recorders)."""
        self._frame_hooks.append(fn)
        return self

    def register_frame_input(self, name: str, initial, fn):
        """Add a host -> device input channel (ref: the winit -> bevy event
        bridge): `initial` (a numpy array) sets the shape and dtype of
        `frame_input[name]`; `fn()` supplies the value at every frame
        start, copied in with the other channels."""
        store = dict(self.world.state["res"].get("frame_input", {}))
        dev = self.world.device
        store.setdefault("dt", torch.zeros((), dtype=torch.float32,
                                           device=dev))
        initial = np.asarray(initial)
        initial = initial.astype(_NARROW.get(initial.dtype, initial.dtype))
        store[name] = torch.as_tensor(initial, device=dev)
        self.world.state["res"]["frame_input"] = store
        self.world.structure_version += 1
        self._input_channels[name] = (fn, initial.dtype)
        return self

    def _gather_frame_inputs(self, dt):
        fin = {"dt": float(dt)}
        for name, (fn, dtype) in self._input_channels.items():
            fin[name] = np.asarray(fn(), dtype)
        return fin

    # ------------------------------------------------------------------
    # run items

    def _items(self, labels, include_frame_end):
        items = [("frame_begin",)] if include_frame_end else []
        stepping = getattr(self, "_stepping", None)
        stepped = set(stepping.labels) if stepping is not None and \
            stepping.enabled else set()
        for label in labels:
            if label in stepped:
                continue      # pulled out of the frame: Stepping.step()
            sched = self.schedules.get(label)
            if sched is not None:
                sched.init_systems(self.world)
                items += [("sys", e) for e in sched.items()]
                fired = {p.spec.name for e in sched.items()
                         for p in e.system.params.values()
                         if isinstance(p, Trigger)}
                for name in fired:
                    for obs in self._observers.get(name, ()):
                        obs.system.init_state(self.world)
                        items.append(("sys", obs))
            if label == RunFixedMainLoop:
                for fl in self.fixed_order:
                    if fl in self.schedules:
                        self.schedules[fl].init_systems(self.world)
                items.append(("fixed",))
        if include_frame_end:
            items.append(("frame_end",))
        if self._lifecycle_observers:
            items = self._splice_lifecycle(items)
        return items

    def _splice_lifecycle(self, items):
        """Lifecycle observers after frame start (host-tier edits land
        between frames) and after every Commands-bearing item."""
        for obs in self._lifecycle_observers:
            obs.system.init_state(self.world)
        out = []
        for it in items:
            out.append(it)
            if it[0] == "frame_begin" or self._item_has_commands(it):
                out += [("sys", obs) for obs in self._lifecycle_observers]
        return out

    def _item_has_commands(self, it):
        if it[0] == "sys":
            return it[1].system.has_commands
        if it[0] == "fixed":
            return any(e.system.has_commands
                       for fl in self.fixed_order if fl in self.schedules
                       for e in self.schedules[fl].entries)
        return False

    def _thunk(self, item):
        """Thunks are (state, fin) -> state; fin holds dt and the input
        channels' host values."""
        world = self.world
        if item[0] == "sys":
            entry = item[1]
            return lambda state, fin: run_entry(entry, state, world)
        if item[0] == "fixed":
            return lambda state, fin: self._fixed_loop(state)
        if item[0] == "frame_begin":
            def frame_begin(state, fin):
                if "frame_input" not in state["res"]:
                    return state
                store = dict(state["res"]["frame_input"])
                store["dt"] = torch.full((), fin["dt"], dtype=torch.float32,
                                         device=world.device)
                chans = {k: v for k, v in fin.items()
                         if k != "dt" and k in store}
                if chans:
                    for k, v in pack_frame_input(chans, world.device).items():
                        store[k] = v.to(store[k].dtype)
                return set_in(state, ("res", "frame_input"), store)
            return frame_begin
        if item[0] == "frame_end":
            def frame_end(state, fin):
                state = clear_observer_buffers(swap_message_buffers(state))
                return set_in(state, ("frame",), state["frame"] + 1)
            return frame_end
        raise ValueError(item)

    def _run_labels(self, labels, include_frame_end=False, dt=0.0):
        """Run a label sequence: device items through their thunks, host
        systems against world.state in between (the item list is rebuilt
        when one changes the world's structure)."""
        fin = self._gather_frame_inputs(dt)
        items = self._items(labels, include_frame_end)
        version = self.world.structure_version
        i = 0
        while i < len(items):
            it = items[i]
            if it[0] == "sys" and it[1].system.host:
                run_host_entry(it[1], self.world)
                if self.world.structure_version != version:
                    version = self.world.structure_version
                    items = self._items(labels, include_frame_end)
            else:
                self.world.state = self._thunk(it)(self.world.state, fin)
            i += 1

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
        self._run_labels(self.startup_order, include_frame_end=False)

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

    def _frame_order(self):
        order = list(self.main_order)
        for label in (ExtractSchedule, Render):
            if label in self.schedules and label not in order:
                order.append(label)
        return order

    def frame_fn(self):
        """The whole frame as one plain function `step(state, dt=1/60,
        fin=None) -> state`, run eagerly (what benchmarks and chip_smoke.py
        time); `fin` defaults to dt and the input channels' values at the
        call. Requires a frame without host systems."""
        self.startup()
        self._run_prepare_hooks()
        items = self._items(self._frame_order(), True)
        host = [it[1].system.name for it in items
                if it[0] == "sys" and it[1].system.host]
        if host:
            raise RuntimeError(f"frame_fn requires a host-free frame; host "
                               f"systems: {host}")
        thunks = [self._thunk(it) for it in items]

        def step(state, dt=1.0 / 60.0, fin=None):
            fin = self._gather_frame_inputs(dt) if fin is None else fin
            for t in thunks:
                state = t(state, fin)
            return state

        return step

    def update(self, dt: Optional[float] = None):
        """One frame (ref: SubApps::update), host systems included."""
        self.startup()
        self._run_prepare_hooks()
        dt = self._frame_dt() if dt is None else float(dt)
        self.last_dt = dt
        self._run_labels(self._frame_order(), include_frame_end=True, dt=dt)
        for hook in self._frame_hooks:
            hook(self)

    def should_exit(self) -> bool:
        """Whether an AppExit message is queued (a host read)."""
        store = self.world.state["msg"].get("app_exit")
        return store is not None and bool(store["count"].sum() > 0)

    def run(self, max_frames: Optional[int] = None,
            dt: Optional[float] = None):
        """Headless loop (ref: ScheduleRunnerPlugin::run_loop): until
        `max_frames`, or until an AppExit message is queued."""
        frames = 0
        while True:
            self.update(dt)
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
            if self.should_exit():
                break
        return self

    @property
    def frame(self) -> int:
        return int(self.world.state["frame"])

    # -- one-shot systems (ref: SystemRegistry, system/system_registry.rs)

    def register_system(self, sys) -> int:
        """An id for `run_system` (ref: World::register_system)."""
        self._one_shot.append(sys)
        return len(self._one_shot) - 1

    def run_system(self, sys_or_id):
        """Run one system now, outside the schedules (ref:
        World::run_system): host systems against world.state, device
        systems on the current state."""
        sys = self._one_shot[sys_or_id] if isinstance(sys_or_id, int) \
            else sys_or_id
        sys.init_state(self.world)
        if sys.host:
            run_host_entry(SystemEntry(sys), self.world)
        else:
            self.world.state = sys.run(self.world.state, self.world)
