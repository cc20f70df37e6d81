"""run_conditions on bevy_tpu_torch — the PyTorch twin of
examples/run_conditions.py (reference: examples/ecs/run_conditions.rs —
a system gated by two conditions, ANDed, each a system returning a
device bool). The gated system runs predicated: no host read a frame.

    python examples/torch_run_conditions.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Res, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402

DT = 1 / 60


@resource
class InputCounter:
    value = field((), torch.int32)
    enabled = field((), torch.int32, default=1)


def build_app(device="cuda"):
    app = App(capacity=8, device=device)
    app.insert_resource(InputCounter())

    @system(name="counter_enabled")
    def counter_enabled(c=Res(InputCounter)):
        return c.enabled > 0

    @system(name="below_five")
    def below_five(c=Res(InputCounter)):
        return c.value < 5

    @system
    def increment(c=ResMut(InputCounter)):
        c.value = c.value + 1

    app.add_systems(Update, increment, run_if=[counter_enabled, below_five])
    return app


def script(app, k):
    """From 3, two increments reach the below_five gate (frames 2-3 run
    gated off); frame 4 runs disabled from 0."""
    if k == 0:
        app.world.set_resource_field("input_counter", "value", 3)
    elif k == 4:
        app.world.set_resource_field("input_counter", "value", 0)
        app.world.set_resource_field("input_counter", "enabled", 0)


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
