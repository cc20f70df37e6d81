"""system_stepping on bevy_tpu_torch — the PyTorch twin of
examples/system_stepping.py (reference: examples/ecs/system_stepping.rs —
a schedule paused and run one system at a time).

    python examples/torch_system_stepping.py --frames 60 --profile 10
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import field, resource  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402

DT = 1 / 60


# an explicit storage name: torch_startup_systems.py defines a Trace
# too, and a claimed name would hang on the order of imports
@resource(name="trace")
class Trace:
    moves = field((), torch.int32)
    collides = field((), torch.int32)


def build_app(device="cuda"):
    app = App(capacity=4, device=device)
    app.add_plugins(TimePlugin())
    app.insert_resource(Trace())

    @system
    def movement(t=ResMut(Trace)):
        t.moves = t.moves + 1

    @system
    def collision(t=ResMut(Trace)):
        t.collides = t.collides + 1

    app.add_systems(Update, [movement, collision], chain=True)
    return app


def script(app, k):
    """The demo's: stepping on before frame 1 (Update paused), one step
    before frame 2, continue and off before frame 3. The app's own
    package's Stepping drives it."""
    if k == 0:
        pkg = type(app).__module__.split(".")[0]
        stepping = importlib.import_module(f"{pkg}.stepping")
        app._st = stepping.Stepping(app).add_schedule(Update)
    elif k == 1:
        app._st.enable()
    elif k == 2:
        app._st.step()
    elif k == 3:
        app._st.continue_()
        app._st.disable()


if __name__ == "__main__":
    from torch_ecs_run import run_twin
    run_twin(sys.modules[__name__])
