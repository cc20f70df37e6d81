"""many_sprites on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/many_sprites.py (reference: examples/stress_tests/many_sprites.rs
— ~100k sprites in a grid, the camera panning at 1000 units/s).

The frame — time, transform propagation and the sprite pass through the
tile raster (kernel B4, bf16 sampling) — runs eagerly on the device given
to `build_app`.

    python examples/torch_many_sprites.py              # 100k sprites
    python examples/torch_many_sprites.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Res, Update, With  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, RenderPlugin, Sprite, SpritePlugin, TextureAtlas,
    checkerboard,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)

CAMERA_SPEED = 1000.0  # ref: many_sprites.rs camera move speed


@system
def move_camera(q=Query(Transform, With(Camera2d)), time=Res(Time)):
    """ref: many_sprites.rs move_camera — pan the view along x."""
    step = CAMERA_SPEED * time.delta
    zero = torch.zeros_like(step)
    q.transform.translation = q.transform.translation + \
        torch.stack([step, zero, zero])


def build_app(n_sprites=100_000, width=1280, height=720, capacity=None,
              camera_scale=8.0, tile_h=32, tile_w=128, pairs_per_sprite=2,
              max_per_tile=256, max_visible=32768, mode="tile",
              sample_dtype="bf16", device="cuda") -> App:
    cap = capacity or 1
    while cap < n_sprites + 8:
        cap *= 2
    app = App(capacity=cap, device=device)
    app.add_plugins(
        TimePlugin(), TransformPlugin(),
        RenderPlugin(width=width, height=height),
        SpritePlugin(tile_h=tile_h, tile_w=tile_w,
                     pairs_per_sprite=pairs_per_sprite,
                     max_per_tile=max_per_tile, max_visible=max_visible,
                     mode=mode, sample_dtype=sample_dtype))
    app.add_systems(Update, move_camera)

    atlas = AtlasBuilder(64, 64)
    handle = atlas.add(checkerboard(64, 8), "tile", srgb=False)
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": atlas.build(app.device)})

    app.world.spawn(Camera2d(scale=camera_scale), *transform_bundle())

    # grid (ref: many_sprites.rs — spacing, half offset to centre)
    side = int(np.ceil(np.sqrt(n_sprites)))
    spacing = 64.0
    idx = np.arange(n_sprites)
    gx = (idx % side - side / 2) * spacing
    gy = (idx // side - side / 2) * spacing
    xyz = np.stack([gx, gy, (idx % 97).astype(np.float32)],
                   axis=1).astype(np.float32)
    u0, v0 = handle["uv_min"]
    u1, v1 = handle["uv_max"]
    tint = np.stack([
        0.5 + 0.5 * np.sin(idx * 0.01),
        0.5 + 0.5 * np.sin(idx * 0.013 + 2.0),
        0.5 + 0.5 * np.sin(idx * 0.017 + 4.0),
        np.ones(n_sprites),
    ], axis=1).astype(np.float32)
    app.world.spawn_batch([
        Sprite(color=tint, size=(48.0, 48.0), uv_min=(u0, v0),
               uv_max=(u1, v1), tex=handle["tex"]),
        Transform(translation=xyz),
        GlobalTransform(translation=xyz),
    ], n_sprites)
    return app


def run_timed(app, label, frames=20, warm=3, profile_frames=0):
    """`warm` frames, then `frames` timed with CUDA events; prints
    ms/frame and the render_stats counters, then optionally profiles.
    Returns the final state."""
    from torch_many_cubes import profile

    step = app.frame_fn()
    state = app.world.state
    for _ in range(warm):
        state = step(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / frames
    stats = {k: int(v) for k, v in state["res"]["render_stats"].items()}
    print(f"{label} on {torch.cuda.get_device_name(0)}: {ms:.3f} ms/frame; "
          f"render_stats after {warm + frames} frames {stats}")
    if profile_frames:
        profile(step, state, profile_frames)
    app.world.state = state
    return state


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(), "many_sprites 100000",
              profile_frames=args.profile)


if __name__ == "__main__":
    main()
