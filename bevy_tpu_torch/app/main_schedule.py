"""Schedule labels & Main order (port of bevy_tpu/app/main_schedule.py;
ref: bevy_app main_schedule.rs:57-200, plus the render labels appended by
the render plugin)."""


class ScheduleLabel(str):
    def __repr__(self):
        return f"<{str(self)}>"


PreStartup = ScheduleLabel("PreStartup")
Startup = ScheduleLabel("Startup")
PostStartup = ScheduleLabel("PostStartup")

First = ScheduleLabel("First")
PreUpdate = ScheduleLabel("PreUpdate")
StateTransition = ScheduleLabel("StateTransition")
RunFixedMainLoop = ScheduleLabel("RunFixedMainLoop")
Update = ScheduleLabel("Update")
SpawnScene = ScheduleLabel("SpawnScene")
PostUpdate = ScheduleLabel("PostUpdate")
Last = ScheduleLabel("Last")

FixedFirst = ScheduleLabel("FixedFirst")
FixedPreUpdate = ScheduleLabel("FixedPreUpdate")
FixedUpdate = ScheduleLabel("FixedUpdate")
FixedPostUpdate = ScheduleLabel("FixedPostUpdate")
FixedLast = ScheduleLabel("FixedLast")

# Render labels (ref: ExtractSchedule + Render, bevy_render/src/lib.rs),
# appended after Last: sim and render run in one frame, in one stream.
ExtractSchedule = ScheduleLabel("ExtractSchedule")
Render = ScheduleLabel("Render")

MAIN_ORDER = [First, PreUpdate, StateTransition, RunFixedMainLoop, Update,
              SpawnScene, PostUpdate, Last]
STARTUP_ORDER = [PreStartup, Startup, PostStartup]
FIXED_MAIN_ORDER = [FixedFirst, FixedPreUpdate, FixedUpdate, FixedPostUpdate,
                    FixedLast]
