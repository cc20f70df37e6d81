"""removal_detection on bevy_tpu_torch — the PyTorch twin of
examples/removal_detection.py (reference:
examples/ecs/removal_detection.rs — the Removed filter sees a removal in
the frame after it, once).

    python examples/torch_removal_detection.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Removed, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import (  # noqa: E402
    component, field, resource,
)
from bevy_tpu_torch.ecs.system import system  # noqa: E402

DT = 1 / 60


@component
class MyComponent:
    tag = field((), torch.int32)


@resource
class RemovalLog:
    count = field((), torch.int32)
    last_row = field((), torch.int32, default=-1)


def build_app(device="cuda"):
    app = App(capacity=16, device=device)
    app.insert_resource(RemovalLog())
    e = app.world.spawn(MyComponent(tag=7))

    @system
    def react_on_removal(q=Query(Removed(MyComponent)),
                         log=ResMut(RemovalLog)):
        n = q.mask.sum(dtype=torch.int32)
        log.count = log.count + n
        rows = torch.arange(q.mask.shape[0], dtype=torch.int32,
                            device=q.mask.device)
        log.last_row = torch.where(n > 0, torch.where(q.mask, rows, -1).max(),
                                   log.last_row)

    app.add_systems(Update, react_on_removal)
    app._target = e
    return app


def script(app, k):
    """The demo's: remove the component before frame 1."""
    if k == 1:
        from torch_ecs_run import spec_named
        app.world.remove(app._target, spec_named(app, "my_component"))


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
