"""many_components on bevy_tpu_torch — the PyTorch twin of
examples/many_components.py (reference:
examples/stress_tests/many_components.rs — 40 component types defined at
run time, 64 entities each, a dozen systems over them).

    python examples/torch_many_components.py --frames 60 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from bevy_tpu_torch import App, Query, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import define_component, field  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402

DT = 1 / 60


def build_app(n_types=40, per_type=64, device="cuda"):
    app = App(capacity=n_types * per_type + 64, device=device)
    app.add_plugins(TimePlugin())
    comps = [define_component(f"stress_c{i}", {"v": field(())})
             for i in range(n_types)]
    for c in comps:
        vals = np.arange(per_type, dtype=np.float32)
        app.world.spawn_batch([c(v=vals)], per_type)

    systems = []
    for i, c in enumerate(comps[:12]):       # a dozen systems over them
        def make(comp, k):
            @system(name=f"bump{k}")
            def bump(q=Query(comp)):
                col = getattr(q, comp.__component_spec__.attr)
                col.v = col.v * 1.0001
            return bump
        systems.append(make(c, i))
    app.add_systems(Update, systems)
    return app


def script(app, k):
    pass


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
