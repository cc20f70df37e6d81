"""sprite_sheet on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/sprite_sheet.py (reference: examples/2d/sprite_sheet.rs — a grid
atlas cycled by a timer through AtlasAnimation).

    python examples/torch_sprite_sheet.py              # 320x180, timed
    python examples/torch_sprite_sheet.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from bevy_tpu_torch import App, Update  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, RenderPlugin, TextureAtlas,
)
from bevy_tpu_torch.render.sprite import (  # noqa: E402
    AtlasAnimation, SpritePlugin, make_atlas_animation_system,
    sprite_from_handle,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def make_sheet(frames=6, fs=16):
    """A procedural walk-cycle sheet: a dot bouncing across each cell."""
    img = np.zeros((fs, fs * frames, 4), np.uint8)
    for f in range(frames):
        cx = fs * f + 3 + (fs - 6) * f // max(frames - 1, 1)
        cy = fs // 2 + int(4 * np.sin(f / frames * 2 * np.pi))
        img[max(cy - 2, 0):cy + 3, max(cx - 2, 0):cx + 3] = \
            (255, 200, 60, 255)
    return img


def build_app(width=320, height=180, device="cuda") -> App:
    app = App(capacity=32, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), SpritePlugin())
    app.world.spawn(Camera2d(), *transform_bundle())
    builder = AtlasBuilder(128, 16)
    handle = builder.add(make_sheet())
    frames = [builder.grid(handle, cols=6, rows=1, index=i)
              for i in range(6)]
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": builder.build(app.device)})
    app.world.spawn(sprite_from_handle(frames[0], size=(64.0, 64.0)),
                    AtlasAnimation(fps=12.0, first=0, count=6),
                    *transform_bundle())
    app.add_systems(Update, make_atlas_animation_system(frames))
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(), "sprite_sheet", profile_frames=args.profile)


if __name__ == "__main__":
    main()
