"""text2d on bevy_tpu_torch — the PyTorch + CUDA twin of examples/text2d.py
(reference: examples/2d/text2d.rs — bitmap glyph sprites, a wrapping box,
the justify modes).

The glyphs are sprites of the default font's atlas (render/text.py), drawn
by the sprite pass through the tile raster (kernel B4).

    python examples/torch_text2d.py              # 480x270, 20 frames timed
    python examples/torch_text2d.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, RenderPlugin, SpritePlugin, TextureAtlas,
)
from bevy_tpu_torch.render.text import FontAtlas, spawn_text  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=480, height=270, device="cuda") -> App:
    app = App(capacity=512, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin())
    app.world.spawn(Camera2d(), *transform_bundle())
    builder = AtlasBuilder(512, 256)
    font = FontAtlas(builder)
    spawn_text(app.world, font, "bevy_tpu text2d",
               pos=(-110.0, 110.0), color=(1.0, 0.9, 0.3, 1.0), size=12)
    spawn_text(app.world, font,
               "wrapped paragraph: the quick brown fox jumps over the "
               "lazy dog, again and again and again",
               pos=(-200.0, 60.0), max_width=180.0,
               color=(0.8, 0.9, 1.0, 1.0))
    spawn_text(app.world, font, "right justified\nacross lines",
               pos=(40.0, 60.0), max_width=160.0, justify="right",
               color=(0.6, 1.0, 0.6, 1.0))
    spawn_text(app.world, font, "centered\ntitle block",
               pos=(-80.0, -40.0), max_width=160.0, justify="center",
               color=(1.0, 0.6, 0.6, 1.0))
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": builder.build(app.device)})
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(), "text2d", profile_frames=args.profile)


if __name__ == "__main__":
    main()
