"""component_hooks on bevy_tpu_torch — the PyTorch twin of
examples/component_hooks.py (reference: examples/ecs/component_hooks.rs —
lifecycle observers keep an inventory count as items come and go).

    python examples/torch_component_hooks.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, ResMut  # noqa: E402
from bevy_tpu_torch.ecs.component import (  # noqa: E402
    component, field, resource,
)
from bevy_tpu_torch.ecs.observer import (  # noqa: E402
    LifecycleMask, OnAdd, OnRemove,
)
from bevy_tpu_torch.ecs.system import system  # noqa: E402

DT = 1 / 60


@component
class Item:
    kind = field((), torch.int32)


@resource
class Inventory:
    count = field((), torch.int32)
    total_ever = field((), torch.int32)


def build_app(device="cuda"):
    app = App(capacity=16, device=device)
    app.insert_resource(Inventory())
    app.world.register_component(Item)

    @system
    def on_item_added(life=LifecycleMask(OnAdd(Item)),
                      inv=ResMut(Inventory)):
        n = life.count()
        inv.count = inv.count + n
        inv.total_ever = inv.total_ever + n

    @system
    def on_item_removed(life=LifecycleMask(OnRemove(Item)),
                        inv=ResMut(Inventory)):
        inv.count = inv.count - life.count()

    app.add_observer(OnAdd(Item), on_item_added)
    app.add_observer(OnRemove(Item), on_item_removed)
    return app


def script(app, k):
    """The demo's two spawns and a despawn, then one more spawn."""
    from torch_ecs_run import spec_named
    item = spec_named(app, "item").cls
    if k == 0:
        app._spawned = [app.world.spawn(item(kind=1)),
                      app.world.spawn(item(kind=2))]
    elif k == 1:
        app.world.despawn(app._spawned[0])
    elif k == 3:
        app.world.spawn(item(kind=3))


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
