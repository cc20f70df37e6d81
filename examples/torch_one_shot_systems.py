"""one_shot_systems on bevy_tpu_torch — the PyTorch twin of
examples/one_shot_systems.py (reference: examples/ecs/one_shot_systems.rs —
a system registered once and run on demand by its id).

    python examples/torch_one_shot_systems.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, ResMut  # noqa: E402
from bevy_tpu_torch.ecs.component import (  # noqa: E402
    component, field, resource,
)
from bevy_tpu_torch.ecs.system import system  # noqa: E402

DT = 1 / 60


@component
class Counter:
    value = field((), torch.int32)


# an explicit storage name: torch_computed_states.py defines a Log
# too, and a claimed name would hang on the order of imports
@resource(name="log")
class Log:
    runs = field((), torch.int32)


def build_app(device="cuda"):
    app = App(capacity=8, device=device)
    app.insert_resource(Log())
    app.world.spawn(Counter())
    app.world.spawn(Counter(value=100))

    @system
    def increment_all(q=Query(Counter), log=ResMut(Log)):
        q.counter.value = q.counter.value + 1
        log.runs = log.runs + 1

    app._increment_id = app.register_system(increment_all)
    return app


def script(app, k):
    """The demo's two runs on demand after the first frame, one more
    before frame 3."""
    if k == 1:
        app.run_system(app._increment_id)
        app.run_system(app._increment_id)
    elif k == 3:
        app.run_system(app._increment_id)


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
