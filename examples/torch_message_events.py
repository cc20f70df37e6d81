"""message_events on bevy_tpu_torch — the PyTorch twin of
examples/message_events.py (reference: examples/ecs/event.rs — the
double-buffered message channel).

    python examples/torch_message_events.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import (  # noqa: E402
    App, MessageReader, MessageWriter, Res, ResMut, Update, message,
)
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402

# frames of 0.15 s: hits start at the fourth frame (elapsed > 0.5)
DT = 0.15


@message
class DealDamage:
    amount = field((), torch.float32)


@resource
class Health:
    value = field((), torch.float32, default=100.0)
    hits = field((), torch.int32)


def build_app(device="cuda"):
    app = App(capacity=8, device=device)
    app.add_plugins(TimePlugin())
    app.add_message(DealDamage, capacity=8)
    app.insert_resource(Health())

    @system
    def attack(w=MessageWriter(DealDamage, budget=1), time=Res(Time)):
        # one hit every frame after the first half second
        w.send(count=(time.elapsed > 0.5).to(torch.int32), amount=3.0)

    @system
    def apply_damage(r=MessageReader(DealDamage), hp=ResMut(Health)):
        fields, mask = r.read()
        hp.value = hp.value - torch.where(mask, fields["amount"], 0.0).sum()
        hp.hits = hp.hits + mask.sum(dtype=torch.int32)

    app.add_systems(Update, attack)
    app.add_systems(Update, apply_damage, after="attack")
    return app


def script(app, k):
    pass


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
