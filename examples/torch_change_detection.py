"""change_detection on bevy_tpu_torch — the PyTorch twin of
examples/change_detection.py (reference: examples/ecs/change_detection.rs —
the Changed / Added query filters over per-row change ticks).

    python examples/torch_change_detection.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import (  # noqa: E402
    Added, App, Changed, Query, ResMut, Update, With,
)
from bevy_tpu_torch.ecs.component import (  # noqa: E402
    component, field, resource,
)
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402

DT = 1 / 60


# an explicit storage name: torch_breakout.py defines a Score
# too, and a claimed name would hang on the order of imports
@component(name="score")
class Score:
    value = field((), torch.float32)


@component
class Bumped:
    """Marker: this entity's Score is written every frame."""


@resource
class ChangeLog:
    changed_seen = field((), torch.int32)   # rows matched by Changed(Score)
    added_seen = field((), torch.int32)     # rows matched by Added(Score)


def build_app(device="cuda"):
    app = App(capacity=16, device=device)
    app.add_plugins(TimePlugin())
    app.insert_resource(ChangeLog())
    app.world.spawn(Score(value=0.0), Bumped())
    app.world.spawn(Score(value=10.0), Bumped())
    app.world.spawn(Score(value=20.0))      # never written after spawn

    @system
    def bump(q=Query(Score, With(Bumped))):
        q.score.value = q.score.value + 1.0

    @system
    def react(q=Query(Score, Changed(Score)),
              qa=Query(Score, Added(Score)), log=ResMut(ChangeLog)):
        log.changed_seen = log.changed_seen + q.count()
        log.added_seen = log.added_seen + qa.count()

    app.add_systems(Update, [bump, react], chain=True)
    return app


def script(app, k):
    pass


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
