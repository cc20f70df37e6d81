"""many_text2d on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/many_text2d.py (reference: examples/stress_tests/many_text2d.rs —
thousands of glyph sprites from the text pipeline).

The JAX example's scene (seed 5, six words) at its label density: 120
labels at 640x360, so 480 at the default 1280x720, about 2,200 glyph
sprites, drawn through the tile raster (kernel B4) or, with
`--mode splat`, the window splat (kernel B5).

    python examples/torch_many_text2d.py              # 1280x720, 480 labels
    python examples/torch_many_text2d.py --mode splat --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, RenderPlugin, SpritePlugin, TextureAtlas,
)
from bevy_tpu_torch.render.text import FontAtlas, spawn_text  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)

WORDS = ["bevy", "tpu", "text", "stress", "glyphs", "fast"]


def n_labels_for(width, height):
    """The JAX example's density: 120 labels on 640x360."""
    return round(120 * width * height / (640 * 360))


def build_app(width=1280, height=720, n_labels=None, mode="tiles",
              device="cuda") -> App:
    n_labels = n_labels_for(width, height) if n_labels is None else n_labels
    app = App(capacity=8192, device=device)
    builder = AtlasBuilder(512, 512)
    font = FontAtlas(builder)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin(max_visible=8192, mode=mode))
    app.world.spawn(Camera2d(), *transform_bundle())
    rng = np.random.default_rng(5)
    for i in range(n_labels):
        x = float(rng.uniform(-width / 2 + 40, width / 2 - 40))
        y = float(rng.uniform(-height / 2 + 10, height / 2 - 10))
        col = tuple(rng.random(3) * 0.8 + 0.2) + (1.0,)
        spawn_text(app.world, font, WORDS[i % len(WORDS)], pos=(x, y),
                   color=col)
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": builder.build(app.device)})
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="tiles", choices=("tiles", "splat"))
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    app = build_app(mode=args.mode)
    run_timed(app, f"many_text2d {n_labels_for(1280, 720)} labels "
              f"({app.world.entity_count() - 1} glyphs, {args.mode})",
              profile_frames=args.profile)


if __name__ == "__main__":
    main()
