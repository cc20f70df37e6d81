"""startup_systems on bevy_tpu_torch — the PyTorch twin of
examples/startup_systems.py (reference: examples/ecs/startup_system.rs —
PreStartup / Startup / PostStartup run once, in order, before the first
frame).

    python examples/torch_startup_systems.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import (  # noqa: E402
    App, PostStartup, PreStartup, ResMut, Startup, Update,
)
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402

DT = 1 / 60


# an explicit storage name: torch_system_stepping.py defines a Trace
# too, and a claimed name would hang on the order of imports
@resource(name="trace")
class Trace:
    order = field((4,), torch.int32, default=(0, 0, 0, 0))
    clock = field((), torch.int32)
    frames = field((), torch.int32)


def build_app(device="cuda"):
    app = App(capacity=8, device=device)
    app.insert_resource(Trace())

    def stamp(slot):
        @system(name=f"stamp{slot}")
        def s(t=ResMut(Trace)):
            t.clock = t.clock + 1
            hit = torch.arange(4, device=t.order.device) == slot
            t.order = torch.where(hit, t.clock, t.order)
        return s

    @system
    def per_frame(t=ResMut(Trace)):
        t.frames = t.frames + 1

    app.add_systems(PreStartup, stamp(0))
    app.add_systems(Startup, stamp(1))
    app.add_systems(PostStartup, stamp(2))
    app.add_systems(Update, per_frame)
    return app


def script(app, k):
    pass


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
