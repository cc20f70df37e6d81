"""Time (port of bevy_tpu/time/__init__.py; ref: bevy_time —
Time<Real>/Time<Virtual>/Time<Fixed> with the overstep accumulator,
`src/fixed.rs:69,181`).

The generic `Time` resource follows the current context clock: virtual
time in the main schedules, fixed time inside FixedMain (the App's fixed
loop swaps it).
"""

import torch

from bevy_tpu_torch.app.main_schedule import First
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import field, resource
from bevy_tpu_torch.ecs.query import Res, ResMut
from bevy_tpu_torch.ecs.system import system

DEFAULT_FIXED_HZ = 64.0  # ref: bevy_time Fixed default 64 Hz


@resource
class Time:
    delta = field(())
    elapsed = field(())


@resource
class TimeReal:
    delta = field(())
    elapsed = field(())


@resource
class TimeVirtual:
    delta = field(())
    elapsed = field(())
    relative_speed = field((), default=1.0)
    paused = field((), torch.bool, default=False)
    max_delta = field((), default=0.25)  # ref: Virtual::max_delta


@resource
class TimeFixed:
    timestep = field((), default=1.0 / DEFAULT_FIXED_HZ)
    overstep = field(())
    elapsed = field(())


@resource
class FrameInput:
    """Host→device per-frame input written by App.update (dt)."""
    dt = field(())


@resource
class FrameCount:
    count = field((), torch.int32)


@system(name="time_system")
def time_system(inp=Res(FrameInput),
                real=ResMut(TimeReal),
                virt=ResMut(TimeVirtual),
                time=ResMut(Time),
                fixed=ResMut(TimeFixed),
                frames=ResMut(FrameCount)):
    dt = inp.dt
    real.delta = dt
    real.elapsed = real.elapsed + dt
    vdt = torch.minimum(dt, virt.max_delta) * virt.relative_speed
    vdt = torch.where(virt.paused, torch.zeros_like(vdt), vdt)
    virt.delta = vdt
    virt.elapsed = virt.elapsed + vdt
    time.delta = vdt
    time.elapsed = virt.elapsed  # generic clock follows virtual
    # accumulate the fixed overstep (drained by the App's fixed loop)
    fixed.overstep = fixed.overstep + vdt
    frames.count = frames.count + 1


class TimePlugin(Plugin):
    def build(self, app):
        for res in (Time, TimeReal, TimeVirtual, TimeFixed, FrameInput,
                    FrameCount):
            app.init_resource(res())
        app.add_systems(First, time_system)


# ----------------------------------------------------------------------
# Timer / Stopwatch as tensor helpers (ref: bevy_time Timer): a column of
# timers is a dict of tensors, ticked in one batch of element-wise ops.

def timer_new(duration, repeating=False, shape=(), device="cpu"):
    return {
        "elapsed": torch.zeros(shape, dtype=torch.float32, device=device),
        "duration": torch.as_tensor(duration, dtype=torch.float32,
                                    device=device).expand(shape).clone(),
        "repeating": torch.as_tensor(repeating, dtype=torch.bool,
                                     device=device).expand(shape).clone(),
        "finished": torch.zeros(shape, dtype=torch.bool, device=device),
    }


def timer_tick(timer, dt):
    """Returns (new_timer, just_finished mask)."""
    elapsed = timer["elapsed"] + dt
    finished = elapsed >= timer["duration"]
    just = finished & ~timer["finished"] | (finished & timer["repeating"])
    period = torch.clamp(timer["duration"], min=1e-9)
    wrapped = torch.where(timer["repeating"] & finished,
                          torch.remainder(elapsed, period), elapsed)
    new = {
        "elapsed": torch.where(timer["repeating"], wrapped,
                               torch.minimum(elapsed, timer["duration"])),
        "duration": timer["duration"],
        "repeating": timer["repeating"],
        "finished": finished & ~timer["repeating"],
    }
    return new, just
