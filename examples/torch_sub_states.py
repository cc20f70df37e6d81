"""sub_states on bevy_tpu_torch — the PyTorch twin of examples/sub_states.py
(reference: examples/state/sub_states.rs — a Paused sub-state that exists
only while the parent is InGame, driven by key presses through
InputPlugin's frame inputs).

    python examples/torch_sub_states.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Res, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.input import InputPlugin, KeyCode  # noqa: E402
from bevy_tpu_torch.state import (  # noqa: E402
    NextState, OnEnter, add_state, add_sub_state, in_state,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402

DT = 1 / 60


class AppState:
    MENU = 0
    IN_GAME = 1


class Paused:
    RUNNING = 0
    PAUSED = 1


@resource
class Sim:
    steps = field((), torch.int32)     # advances only while RUNNING
    pauses = field((), torch.int32)    # OnEnter(PAUSED) count


def build_app(device="cuda"):
    app = App(capacity=4, device=device)
    app.add_plugins(TimePlugin(), InputPlugin())
    app.insert_resource(Sim())
    add_state(app, "app", AppState.MENU, [AppState.MENU, AppState.IN_GAME])
    add_sub_state(app, "paused", Paused.RUNNING,
                  [Paused.RUNNING, Paused.PAUSED],
                  parent="app", parent_value=AppState.IN_GAME)

    @system
    def start(kb=Res("keyboard"), ns=NextState("app")):
        ns.set(torch.where(kb.just_pressed[KeyCode.Enter],
                           AppState.IN_GAME, AppState.MENU))

    @system
    def toggle_pause(kb=Res("keyboard"), ns=NextState("paused"),
                     cur=Res("state_paused")):
        want = torch.where(cur.current == Paused.RUNNING,
                           Paused.PAUSED, Paused.RUNNING)
        ns.set(torch.where(kb.just_pressed[KeyCode.Space], want,
                           cur.current))

    @system
    def step_sim(s=ResMut(Sim)):
        s.steps = s.steps + 1

    @system
    def on_pause(s=ResMut(Sim)):
        s.pauses = s.pauses + 1

    app.add_systems(Update, start, run_if=in_state("app", AppState.MENU))
    app.add_systems(Update, toggle_pause,
                    run_if=in_state("app", AppState.IN_GAME))
    app.add_systems(Update, step_sim,
                    run_if=in_state("paused", Paused.RUNNING))
    app.add_systems(OnEnter("paused", Paused.PAUSED), on_pause)
    return app


def script(app, k):
    """Enter starts the game, Space pauses it (the demo's presses)."""
    for key, at in ((KeyCode.Enter, 1), (KeyCode.Space, 3)):
        if k == at:
            app.input.press(key)
        elif k == at + 1:
            app.input.release(key)


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
