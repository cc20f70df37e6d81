"""tilemap on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/tilemap.py (reference: examples/2d/tilemap_chunk.rs — a grid of
tiles drawn as one chunk, the tile indices edited at run time).

The chunk is one plain-PyTorch image pass (span tilemap:pass) before the
sprite pass; a system floods the sand tiles with water for the first
second of every two by rewriting the chunk's tile resource.

    python examples/torch_tilemap.py              # 320x180, timed
    python examples/torch_tilemap.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Res, ResMut, Update  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, RenderPlugin, SpritePlugin, TextureAtlas,
)
from bevy_tpu_torch.render.tilemap import (  # noqa: E402
    TilemapChunk, TilemapPlugin,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=320, height=180, device="cuda") -> App:
    app = App(capacity=16, device=device)
    builder = AtlasBuilder(64, 64)
    # a 4x1 sheet: grass, water, sand, rock
    img = np.zeros((16, 64, 4), np.float32)
    for i, c in enumerate([(0.2, 0.7, 0.2), (0.2, 0.4, 0.9),
                           (0.9, 0.8, 0.4), (0.5, 0.5, 0.5)]):
        img[:, 16 * i:16 * (i + 1)] = (*c, 1.0)
    sheet = builder.add(img, srgb=False)

    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 4, (10, 18)).tolist()
    tm = TilemapPlugin()
    tm.add_chunk(TilemapChunk(tiles, sheet, sheet_cols=4, sheet_rows=1,
                              tile_size=16.0, origin=(-144.0, -80.0)))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin(), tm)
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": builder.build(app.device)})
    app.world.spawn(Camera2d(), *transform_bundle())
    original = torch.tensor(tiles, dtype=torch.int32, device=app.device)
    sand = original == 2

    @system
    def tide(chunk=ResMut("tilemap0"), time=Res(Time)):
        # water floods the sand tiles and recedes: run-time tile edits
        flood = torch.remainder(time.elapsed, 2.0) < 1.0
        chunk.tiles = torch.where(sand & flood, 1, original)

    app.add_systems(Update, tide)
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(), "tilemap", profile_frames=args.profile)


if __name__ == "__main__":
    main()
