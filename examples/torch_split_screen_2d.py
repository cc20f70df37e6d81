"""split_screen_2d on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/split_screen_2d.py (the 2D half of Camera::viewport: two
orthographic cameras with half-screen viewport rects, each following its
own arena; ref: Camera::order).

The sprite pass runs with max_cameras=2: one raster call a camera
(kernel B4, or B5 with `--mode splat`), recentred on the camera's
viewport, whose rect is then composited over the frame.

    python examples/torch_split_screen_2d.py              # 1280x720
    python examples/torch_split_screen_2d.py --mode splat --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Read, Res, Update  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera2d  # noqa: E402
from bevy_tpu_torch.render.sprite import Sprite, SpritePlugin  # noqa: E402
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, transform_bundle,
)


@system
def orbit(q=Query(Transform, Read(Sprite)), time=Res(Time)):
    """The two big sprites circle their arena's centre."""
    big = q.sprite.size[:, 0] > 20.0
    t = time.elapsed
    base = q.transform.translation
    home_x = torch.where(base[:, 0] > 2500.0, 5000.0, 0.0)
    r = 80.0
    q.transform.translation = torch.where(
        big[:, None],
        torch.stack([home_x + r * torch.cos(t + home_x),
                     r * torch.sin(t + home_x), base[:, 2]], -1),
        base)


def build_app(width=1280, height=720, mode="tiles", device="cuda") -> App:
    app = App(capacity=256, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin(max_cameras=2, mode=mode))

    # left viewport: the world around the origin; right: a far arena
    app.world.spawn(Camera2d(order=0, vp_min=(0.0, 0.0), vp_max=(0.5, 1.0)),
                    *transform_bundle(translation=(0.0, 0.0, 0.0)))
    app.world.spawn(Camera2d(order=1, vp_min=(0.5, 0.0), vp_max=(1.0, 1.0)),
                    *transform_bundle(translation=(5000.0, 0.0, 0.0)))

    # orbiting "player" sprites, one an arena
    app.world.spawn(Sprite(size=(30.0, 30.0), color=(1.0, 0.3, 0.2, 1.0)),
                    *transform_bundle(translation=(0.0, 0.0, 1.0)))
    app.world.spawn(Sprite(size=(30.0, 30.0), color=(0.2, 0.9, 0.3, 1.0)),
                    *transform_bundle(translation=(5000.0, 0.0, 1.0)))
    # static props, so each camera has context
    for i in range(8):
        a = i / 8 * 2 * np.pi
        for cx, col in ((0.0, (0.4, 0.5, 1.0, 1.0)),
                        (5000.0, (1.0, 0.8, 0.2, 1.0))):
            app.world.spawn(
                Sprite(size=(16.0, 16.0), color=col),
                *transform_bundle(translation=(
                    cx + 120 * np.cos(a), 120 * np.sin(a), 0.0)))
    app.add_systems(Update, orbit)
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="tiles", choices=("tiles", "splat"))
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(mode=args.mode), f"split_screen_2d ({args.mode})",
              profile_frames=args.profile)


if __name__ == "__main__":
    main()
