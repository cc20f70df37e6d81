"""states on bevy_tpu_torch — the PyTorch twin of examples/states.py
(reference: examples/state/states.rs — a Menu / InGame state machine with
OnEnter schedules and in_state run conditions). Transitions and gated
systems run predicated on device bools: a frame reads nothing back.

    python examples/torch_states.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Res, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.state import (  # noqa: E402
    NextState, OnEnter, add_state, in_state,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402

# frames of 0.15 s: "play" is pressed at the fourth frame (elapsed > 0.5)
DT = 0.15


class GameState:
    MENU = 0
    IN_GAME = 1


@resource
class Stats:
    menu_frames = field((), torch.int32)
    game_frames = field((), torch.int32)
    entered_game = field((), torch.int32)   # OnEnter(IN_GAME) fire count


def build_app(device="cuda"):
    app = App(capacity=8, device=device)
    app.add_plugins(TimePlugin())
    app.insert_resource(Stats())
    add_state(app, "game", GameState.MENU,
              [GameState.MENU, GameState.IN_GAME])

    @system
    def menu_tick(s=ResMut(Stats), time=Res(Time), ns=NextState("game")):
        s.menu_frames = s.menu_frames + 1
        # "press play" after half a second
        ns.set(torch.where(time.elapsed > 0.5, GameState.IN_GAME,
                           GameState.MENU))

    @system
    def game_tick(s=ResMut(Stats)):
        s.game_frames = s.game_frames + 1

    @system
    def setup_game(s=ResMut(Stats)):
        s.entered_game = s.entered_game + 1

    app.add_systems(Update, menu_tick,
                    run_if=in_state("game", GameState.MENU))
    app.add_systems(Update, game_tick,
                    run_if=in_state("game", GameState.IN_GAME))
    app.add_systems(OnEnter("game", GameState.IN_GAME), setup_game)
    return app


def script(app, k):
    pass


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
