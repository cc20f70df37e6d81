"""computed_states on bevy_tpu_torch — the PyTorch twin of
examples/computed_states.py (reference: examples/state/computed_states.rs
+ sub_states.rs — a derived overlay state and a tutorial sub-state).

    python examples/torch_computed_states.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.state import (  # noqa: E402
    OnEnter, add_computed_state, add_state, add_sub_state, in_state,
)

DT = 1 / 60


class AppState:
    MENU = 0
    PLAYING = 1
    PAUSED = 2


class Tutorial:          # sub-state: exists only while PLAYING
    ON = 0
    OFF = 1


# an explicit storage name: torch_one_shot_systems.py defines a Log
# too, and a claimed name would hang on the order of imports
@resource(name="log")
class Log:
    overlay_enters = field((), torch.int32)
    tutorial_frames = field((), torch.int32)


def build_app(device="cuda"):
    app = App(capacity=16, device=device)
    app.insert_resource(Log())
    add_state(app, "app", AppState.MENU,
              [AppState.MENU, AppState.PLAYING, AppState.PAUSED])
    # derived overlay: shown whenever not actively playing
    add_computed_state(
        app, "overlay", values=[0, 1], sources=["app"],
        compute=lambda s: torch.where(s["app"] == AppState.PLAYING, 0, 1),
        initial=1)
    add_sub_state(app, "tutorial", Tutorial.ON, [Tutorial.ON, Tutorial.OFF],
                  parent="app", parent_value=AppState.PLAYING)

    @system
    def on_overlay_enter(log=ResMut(Log)):
        log.overlay_enters = log.overlay_enters + 1

    @system
    def tutorial_tick(log=ResMut(Log)):
        log.tutorial_frames = log.tutorial_frames + 1

    app.add_systems(OnEnter("overlay", 1), on_overlay_enter)
    app.add_systems(Update, tutorial_tick,
                    run_if=in_state("tutorial", Tutorial.ON))
    return app


def script(app, k):
    """The demo's: PLAYING before frame 1, PAUSED before frame 4."""
    if k == 1:
        app.world.set_resource_field("state_app", "next", AppState.PLAYING)
    elif k == 4:
        app.world.set_resource_field("state_app", "next", AppState.PAUSED)


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
