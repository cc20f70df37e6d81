"""bevymark on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/bevymark.py (reference: examples/stress_tests/bevymark.rs —
10k birds a second spawned inside the frame, gravity, edge bounce).

Birds spawn through device-tier Commands (ecs/commands.py): free rows of
the fixed-capacity pools are claimed on the device with a static
per-frame budget, so a frame reads nothing back. The sprite pass draws
them through the window-splat raster (kernel B5; axis-aligned, alpha-only
atlas, bf16 sampling).

    python examples/torch_bevymark.py              # 150 frames, then timed
    python examples/torch_bevymark.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import (  # noqa: E402
    App, Commands, Query, Res, Update, component, field,
)
from bevy_tpu_torch.color import srgba  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, ClearColor, RenderPlugin, Sprite, SpritePlugin,
    TextureAtlas,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)

# ref: bevymark.rs constants
BIRD_SPEED = 500.0
GRAVITY = -980.0
MAX_VELOCITY = 750.0
BIRD_SIZE = 32.0
SPAWN_PER_SEC = 10_000


@component
class Bird:
    velocity = field(2)


def _hash01(x):
    """Counter-based pseudo-random in [0, 1) from int32 `x` (int32
    wrap-around, as the JAX twin's)."""
    x = (x * 1103515245 + 12345) & 0x7FFFFFFF
    x = (x * 1103515245 + 12345) & 0x7FFFFFFF
    return (x % 65536).to(torch.float32) / 65536.0


def make_spawn_system(handle, half_w, half_h, budget=256):
    u0, v0 = handle["uv_min"]
    u1, v1 = handle["uv_max"]

    @system(name="spawn_birds")
    def spawn_birds(commands=Commands(budget=budget), time=Res(Time),
                    frames=Res("frame_count")):
        # min(10000 * dt, budget) in f32, truncated to int32
        count = torch.clamp(SPAWN_PER_SEC * time.delta,
                            max=float(budget)).to(torch.int32)
        lane = torch.arange(budget, dtype=torch.int32,
                            device=time.delta.device)
        seed = frames.count * budget + lane
        vel = torch.stack([BIRD_SPEED * (0.5 + 0.5 * _hash01(seed)),
                           MAX_VELOCITY * (_hash01(seed + 7919) - 0.5)], 1)
        ones = torch.ones(budget, device=lane.device)
        commands.spawn(
            Bird(velocity=vel),
            Sprite(size=(BIRD_SIZE, BIRD_SIZE), uv_min=(u0, v0),
                   uv_max=(u1, v1), tex=handle["tex"],
                   color=torch.stack([0.5 + 0.5 * _hash01(seed + 13),
                                      0.5 + 0.5 * _hash01(seed + 101),
                                      0.5 + 0.5 * _hash01(seed + 211),
                                      ones], 1)),
            Transform(translation=torch.stack(
                [ones * (-half_w + BIRD_SIZE), ones * (half_h - BIRD_SIZE),
                 _hash01(seed + 31) * 10.0], 1)),
            GlobalTransform(),
            count=count)

    return spawn_birds


def make_movement_system(half_w, half_h):
    @system(name="bird_movement")
    def bird_movement(q=Query(Transform, Bird), time=Res(Time)):
        """ref: movement_system + collision_system (gravity, edge bounce)."""
        dt = time.delta
        pos = q.transform.translation
        vel = q.bird.velocity
        # pos + vel * dt with one rounding: the JAX twin's XLA CPU build
        # fuses this multiply-add, and the birds must match it bit for bit
        new_pos2 = torch.addcmul(pos[:, :2], vel, dt)
        vy = vel[:, 1] + GRAVITY * dt
        hx = half_w - BIRD_SIZE / 2
        hy = half_h - BIRD_SIZE / 2
        vx = torch.where(torch.abs(new_pos2[:, 0]) > hx, -vel[:, 0],
                         vel[:, 0])
        vy = torch.where(new_pos2[:, 1] < -hy, torch.abs(vy),
                         torch.where(new_pos2[:, 1] > hy, -torch.abs(vy),
                                     vy))
        vy = torch.clamp(vy, -MAX_VELOCITY, MAX_VELOCITY)
        q.bird.velocity = torch.stack([vx, vy], 1)
        q.transform.translation = torch.cat([
            torch.clamp(new_pos2[:, 0:1], -hx, hx),
            torch.clamp(new_pos2[:, 1:2], -hy, hy), pos[:, 2:]], 1)

    return bird_movement


def build_app(width=1280, height=720, capacity=49152, spawn_budget=256,
              max_per_tile=1024, max_visible=49152, sample_dtype="bf16",
              mode="splat", device="cuda") -> App:
    app = App(capacity=capacity, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin(max_visible=min(max_visible, capacity),
                                 max_per_tile=max_per_tile,
                                 pairs_per_sprite=2,  # birds span <= 2
                                 mode=mode, sample_dtype=sample_dtype,
                                 rotated=False, alpha_only=True))
    app.insert_resource(ClearColor(color=tuple(
        srgba(0.1, 0.1, 0.12).tolist())))

    atlas = AtlasBuilder(32, 32)
    yy, xx = np.mgrid[0:32, 0:32]
    d = np.sqrt((xx - 15.5) ** 2 + (yy - 15.5) ** 2)
    bird = np.ones((32, 32, 4), np.float32)
    bird[..., 3] = np.clip(15.5 - d + 0.5, 0, 1)
    handle = atlas.add(bird, "bird", srgb=False)
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": atlas.build(app.device)})

    app.world.spawn(Camera2d(), *transform_bundle())
    app.world.register_component(Bird)
    app.add_systems(Update, [
        make_spawn_system(handle, width / 2, height / 2, spawn_budget),
        make_movement_system(width / 2, height / 2)], chain=True)
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    app = build_app()
    state = run_timed(app, "bevymark (150 frames to build the flock)",
                      frames=20, warm=150, profile_frames=args.profile)
    print(f"birds alive: {int(state['ent']['alive'].sum()) - 1}")


if __name__ == "__main__":
    main()
