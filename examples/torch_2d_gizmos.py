"""2d_gizmos on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/2d_gizmos.py (reference: examples/gizmos/2d_gizmos.rs — the
immediate-mode debug-draw vocabulary).

Each frame a system appends a line, a circle whose radius breathes, a
rectangle, a turning arrow and a wave line strip; the gizmo pass draws
the segments as rotated quads through the tile raster (kernel B4; spans
gizmo:prep, gizmo:tiles_B4).

    python examples/torch_2d_gizmos.py              # 480x270, timed
    python examples/torch_2d_gizmos.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Res, Update  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    Camera2d, RenderPlugin, SpritePlugin,
)
from bevy_tpu_torch.render.gizmos import Gizmos, GizmosPlugin  # noqa: E402
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


@system
def draw(g=Gizmos(), time=Res(Time)):
    t = time.elapsed
    g.line_2d((-180.0, 0.0), (180.0, 0.0), color=(0.4, 0.4, 0.5, 1.0))
    g.circle_2d((0.0, 0.0), 60.0 + 10.0 * torch.sin(t),
                color=(1.0, 0.4, 0.2, 1.0))
    g.rect_2d((-120.0, 50.0), (60.0, 40.0), color=(0.2, 0.9, 0.4, 1.0))
    g.arrow_2d((100.0, -60.0),
               torch.stack([100.0 + 50.0 * torch.cos(t),
                            -60.0 + 50.0 * torch.sin(t)]),
               color=(0.4, 0.6, 1.0, 1.0))
    i = torch.arange(8, dtype=torch.float32, device=t.device)
    pts = torch.stack([-160.0 + 20.0 * i, -90.0 + 25.0 * torch.sin(t + i)],
                      1)
    g.linestrip_2d(pts, color=(1.0, 0.9, 0.3, 1.0))


def build_app(width=480, height=270, device="cuda") -> App:
    app = App(capacity=64, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin(), GizmosPlugin(capacity=512))
    app.world.spawn(Camera2d(), *transform_bundle())
    app.add_systems(Update, draw)
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(), "2d_gizmos", profile_frames=args.profile)


if __name__ == "__main__":
    main()
