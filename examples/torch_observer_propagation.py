"""observer_propagation on bevy_tpu_torch — the PyTorch twin of
examples/observer_propagation.py (reference:
examples/ecs/observer_propagation.rs — an Attack on a goblin's helmet
bubbles up the ChildOf chain). The event buffer and its count stay on the
device: the observer reads its budget's slots masked by the count.

    python examples/torch_observer_propagation.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import component, field  # noqa: E402
from bevy_tpu_torch.ecs.observer import On, Trigger, event  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, set_parent, transform_bundle,
)

DT = 1 / 60


@component
class HitPoints:
    value = field((), torch.float32, default=10.0)


@event
class Attack:
    row = field((), torch.int32)
    damage = field((), torch.float32)


def build_app(device="cuda"):
    app = App(capacity=32, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin())
    goblin = app.world.spawn(HitPoints(value=20.0), *transform_bundle())
    helmet = app.world.spawn(HitPoints(value=5.0), *transform_bundle())
    set_parent(app.world, helmet, goblin)
    target = helmet.index

    @system
    def swing(t=Trigger(Attack, budget=2)):
        t.trigger(count=1, row=target, damage=3.0)

    @system
    def take_damage(ev=On(Attack, bubble=True), q=Query(HitPoints)):
        # the helmet and the goblin behind it both see the hit
        fields, valid = ev.read()
        dmg = torch.where(valid, fields["damage"], 0.0).max()
        hit = ev.bubble_mask()
        q.hit_points.value = q.hit_points.value - \
            hit.to(torch.float32)[:q.hit_points.value.shape[0]] * dmg

    app.add_systems(Update, swing)
    app.add_observer(Attack, take_damage)
    app._entities = (goblin, helmet)
    return app


def script(app, k):
    pass


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
