"""ecs_hierarchy on bevy_tpu_torch — the PyTorch twin of
examples/ecs_hierarchy.py (reference: examples/ecs/hierarchy.rs — a
parent with children and a grandchild, reparented at runtime; transform
propagation carries the parent's spin to them).

    python examples/torch_ecs_hierarchy.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Res, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import component, field  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.math import quat_from_axis_angle, quat_mul  # noqa: E402
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, set_parent, transform_bundle,
)

DT = 1 / 30


@component
class Spinner:
    speed = field((), torch.float32, default=1.0)


def build_app(device="cuda"):
    app = App(capacity=32, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin())
    parent = app.world.spawn(Spinner(speed=1.5),
                             *transform_bundle(translation=(0.0, 0.0, 0.0)))
    c1 = app.world.spawn(*transform_bundle(translation=(2.0, 0.0, 0.0)))
    c2 = app.world.spawn(*transform_bundle(translation=(-2.0, 0.0, 0.0)))
    g1 = app.world.spawn(*transform_bundle(translation=(0.0, 1.0, 0.0)))
    set_parent(app.world, c1, parent)
    set_parent(app.world, c2, parent)
    set_parent(app.world, g1, c1)

    @system
    def spin(q=Query(Transform, Spinner), time=Res(Time)):
        ang = q.spinner.speed * time.delta
        axis = torch.tensor([0.0, 0.0, 1.0], device=ang.device)
        dq = quat_from_axis_angle(axis, ang)
        q.transform.rotation = quat_mul(dq.expand(q.transform.rotation.shape),
                                        q.transform.rotation)

    app.add_systems(Update, spin)
    app._entities = {"parent": parent, "c1": c1, "c2": c2, "g1": g1}
    return app


def script(app, k):
    """Detach c2 before frame 3 (ref: remove_parent)."""
    if k == 3:
        from torch_ecs_run import spec_named
        app.world.remove(app._entities["c2"], spec_named(app, "child_of"))


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
