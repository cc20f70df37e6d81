"""Breakout on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/breakout.py (reference: examples/showcase/breakout.rs — the same
constants, the same chained Update systems apply_velocity -> move_paddle
-> check_for_collisions, the same collision rules, vectorized over all
colliders).

Deviations from the reference, as in the JAX twin: a PaddleControl
resource (-1/0/1, with an autopilot that tracks the ball) instead of the
keyboard, the ball is a textured sprite disc, the score is a resource.
Bricks are despawned by device-tier Commands and each collision sends a
BallCollided message. The sprites go through the tile raster (kernel B4,
f32 sampling).

    python examples/torch_breakout.py              # 240 frames, score
    python examples/torch_breakout.py --profile 10 # + timed and profiled
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import (  # noqa: E402
    App, Commands, Query, Read, Res, ResMut, Update, With, component, field,
    resource,
)
from bevy_tpu_torch.color import srgba  # noqa: E402
from bevy_tpu_torch.ecs.message import MessageWriter, message  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    AtlasBuilder, Camera2d, ClearColor, RenderPlugin, Sprite, SpritePlugin,
    TextureAtlas, sprite_from_handle,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)

# Constants (ref: breakout.rs:14-51, transform units = pixels)
PADDLE_SIZE = (120.0, 20.0)
GAP_BETWEEN_PADDLE_AND_FLOOR = 60.0
PADDLE_SPEED = 500.0
PADDLE_PADDING = 10.0

BALL_STARTING_POSITION = (0.0, -50.0, 1.0)
BALL_DIAMETER = 30.0
BALL_SPEED = 400.0
INITIAL_BALL_DIRECTION = (0.5, -0.5)

WALL_THICKNESS = 10.0
LEFT_WALL, RIGHT_WALL = -450.0, 450.0
BOTTOM_WALL, TOP_WALL = -300.0, 300.0

BRICK_SIZE = (100.0, 30.0)
GAP_BETWEEN_PADDLE_AND_BRICKS = 270.0
GAP_BETWEEN_BRICKS = 5.0
GAP_BETWEEN_BRICKS_AND_CEILING = 20.0
GAP_BETWEEN_BRICKS_AND_SIDES = 20.0

BACKGROUND_COLOR = tuple(srgba(0.9, 0.9, 0.9).tolist())
PADDLE_COLOR = tuple(srgba(0.3, 0.3, 0.7).tolist())
BALL_COLOR = tuple(srgba(1.0, 0.5, 0.5).tolist())
BRICK_COLOR = tuple(srgba(0.5, 0.5, 1.0).tolist())
WALL_COLOR = tuple(srgba(0.8, 0.8, 0.8).tolist())


@component
class Paddle:
    pass


@component
class Ball:
    pass


@component
class Brick:
    pass


@component
class Collider:
    pass


@component
class Velocity:
    value = field(2)


@resource
class Score:
    value = field((), torch.int32)


@resource
class PaddleControl:
    """-1 / 0 / +1 steering (ref: keyboard ArrowLeft/ArrowRight)."""
    direction = field(())
    autoplay = field((), torch.bool, default=True)


@message
class BallCollided:
    """ref: BallCollided event (breakout.rs:87), a buffered message."""
    hits = field((), torch.int32)


@system
def apply_velocity(q=Query(Transform, Read(Velocity)), time=Res(Time)):
    """ref: apply_velocity (breakout.rs:319)."""
    t = q.transform.translation
    q.transform.translation = torch.cat(
        [t[:, :2] + q.velocity.value * time.delta, t[:, 2:]], 1)


@system
def autopilot(q=Query(Read(Transform), With(Ball)),
              ctrl=ResMut(PaddleControl),
              p=Query(Read(Transform), With(Paddle))):
    """Headless stand-in for keyboard input: steer toward the ball."""
    ball_idx = torch.argmax(q.mask.to(torch.uint8))
    pad_idx = torch.argmax(p.mask.to(torch.uint8))
    dx = q.transform.translation[ball_idx, 0] - \
        p.transform.translation[pad_idx, 0]
    auto_dir = torch.sign(torch.where(torch.abs(dx) < 5.0, 0.0, dx))
    ctrl.direction = torch.where(ctrl.autoplay, auto_dir, ctrl.direction)


@system
def move_paddle(q=Query(Transform, With(Paddle)), ctrl=Res(PaddleControl),
                time=Res(Time)):
    """ref: move_paddle (breakout.rs:292) — the same clamp bounds."""
    left = LEFT_WALL + WALL_THICKNESS / 2 + PADDLE_SIZE[0] / 2 + \
        PADDLE_PADDING
    right = RIGHT_WALL - WALL_THICKNESS / 2 - PADDLE_SIZE[0] / 2 - \
        PADDLE_PADDING
    t = q.transform.translation
    new_x = torch.clamp(t[:, 0] + ctrl.direction * PADDLE_SPEED * time.delta,
                        left, right)
    q.transform.translation = torch.cat([new_x[:, None], t[:, 1:]], 1)


@system
def check_for_collisions(ball=Query(Velocity, Read(Transform), With(Ball)),
                         col=Query(Read(Transform), With(Collider)),
                         bricks=Query(Read(Transform), With(Brick)),
                         score=ResMut(Score),
                         commands=Commands(),
                         events=MessageWriter(BallCollided, budget=1)):
    """ref: check_for_collisions (breakout.rs:334) — circle-vs-AABB over
    all colliders at once; a reflection fires if any collider demands it
    on that axis."""
    bi = torch.argmax(ball.mask.to(torch.uint8))
    pos = ball.transform.translation[bi, :2]
    vel = ball.velocity.value[bi]
    r = BALL_DIAMETER / 2.0

    centers = col.transform.translation[:, :2]
    half = col.transform.scale[:, :2] * 0.5   # unit sprites scaled
    closest = torch.minimum(torch.maximum(pos, centers - half),
                            centers + half)
    offset = pos - closest
    d2 = torch.sum(offset * offset, -1)
    hit = col.mask & (d2 < r * r)

    # side selection (ref: ball_collision breakout.rs:405)
    ox, oy = offset[:, 0], offset[:, 1]
    side_x = torch.abs(ox) > torch.abs(oy)
    left = side_x & (ox < 0.0)
    right = side_x & (ox >= 0.0)
    top = ~side_x & (oy > 0.0)
    bottom = ~side_x & (oy <= 0.0)
    # reflect only against the approach direction (ref:365-372)
    reflect_x = torch.any(hit & ((left & (vel[0] > 0)) |
                                 (right & (vel[0] < 0))))
    reflect_y = torch.any(hit & ((top & (vel[1] < 0)) |
                                 (bottom & (vel[1] > 0))))
    new_vel = torch.stack([torch.where(reflect_x, -vel[0], vel[0]),
                           torch.where(reflect_y, -vel[1], vel[1])])
    ball.velocity.value = torch.where(ball.mask[:, None], new_vel[None, :],
                                      ball.velocity.value)

    # brick despawn + score (ref:356-359)
    brick_hit = hit & bricks.mask
    commands.despawn(brick_hit)
    score.value = score.value + brick_hit.to(torch.int32).sum()

    n_hits = hit.to(torch.int32).sum()
    events.send(count=torch.clamp(n_hits, max=1), hits=n_hits)


def build_app(width=1280, height=720, capacity=128, camera_scale=1.0,
              ball_velocity=None, autoplay=True, device="cuda") -> App:
    app = App(capacity=capacity, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), SpritePlugin())
    app.insert_resource(ClearColor(color=BACKGROUND_COLOR))
    app.insert_resource(Score())
    app.insert_resource(PaddleControl(autoplay=autoplay))
    app.add_message(BallCollided, capacity=4)
    app.add_systems(Update, [autopilot, apply_velocity, move_paddle,
                             check_for_collisions], chain=True)

    # atlas: a procedural antialiased disc for the ball
    atlas = AtlasBuilder(64, 64)
    yy, xx = np.mgrid[0:64, 0:64]
    dist = np.sqrt((xx - 31.5) ** 2 + (yy - 31.5) ** 2)
    disc = np.ones((64, 64, 4), np.float32)
    disc[..., 3] = np.clip(31.5 - dist + 0.5, 0.0, 1.0)
    ball_handle = atlas.add(disc, "disc", srgb=False)
    app.insert_resource(TextureAtlas.RESOURCE,
                        {"data": atlas.build(app.device)})

    # world setup (ref: setup, breakout.rs:172)
    w = app.world
    w.spawn(Camera2d(scale=camera_scale), *transform_bundle())

    paddle_y = BOTTOM_WALL + GAP_BETWEEN_PADDLE_AND_FLOOR
    w.spawn(Paddle(), Collider(), Sprite(color=PADDLE_COLOR, size=(1.0, 1.0)),
            *transform_bundle(translation=(0.0, paddle_y, 0.0),
                              scale=(PADDLE_SIZE[0], PADDLE_SIZE[1], 1.0)))

    v = np.asarray(ball_velocity if ball_velocity is not None
                   else np.asarray(INITIAL_BALL_DIRECTION) /
                   np.linalg.norm(INITIAL_BALL_DIRECTION) * BALL_SPEED,
                   np.float32)
    w.spawn(Ball(), Velocity(value=tuple(v)),
            sprite_from_handle(ball_handle, color=BALL_COLOR,
                               size=(BALL_DIAMETER, BALL_DIAMETER)),
            *transform_bundle(translation=BALL_STARTING_POSITION))

    arena_w, arena_h = RIGHT_WALL - LEFT_WALL, TOP_WALL - BOTTOM_WALL
    walls = [
        ((LEFT_WALL, 0.0), (WALL_THICKNESS, arena_h + WALL_THICKNESS)),
        ((RIGHT_WALL, 0.0), (WALL_THICKNESS, arena_h + WALL_THICKNESS)),
        ((0.0, BOTTOM_WALL), (arena_w + WALL_THICKNESS, WALL_THICKNESS)),
        ((0.0, TOP_WALL), (arena_w + WALL_THICKNESS, WALL_THICKNESS)),
    ]
    for pos, size in walls:
        w.spawn(Collider(), Sprite(color=WALL_COLOR, size=(1.0, 1.0)),
                *transform_bundle(translation=(pos[0], pos[1], 0.0),
                                  scale=(size[0], size[1], 1.0)))

    # bricks (ref:240-289)
    total_w = arena_w - 2 * GAP_BETWEEN_BRICKS_AND_SIDES
    bottom_edge = paddle_y + GAP_BETWEEN_PADDLE_AND_BRICKS
    total_h = TOP_WALL - bottom_edge - GAP_BETWEEN_BRICKS_AND_CEILING
    n_cols = int(total_w // (BRICK_SIZE[0] + GAP_BETWEEN_BRICKS))
    n_rows = int(total_h // (BRICK_SIZE[1] + GAP_BETWEEN_BRICKS))
    center = (LEFT_WALL + RIGHT_WALL) / 2
    left_edge = center - n_cols / 2 * BRICK_SIZE[0] - \
        (n_cols - 1) / 2 * GAP_BETWEEN_BRICKS
    off_x = left_edge + BRICK_SIZE[0] / 2
    off_y = bottom_edge + BRICK_SIZE[1] / 2
    xyz = np.asarray([
        (off_x + c * (BRICK_SIZE[0] + GAP_BETWEEN_BRICKS),
         off_y + r * (BRICK_SIZE[1] + GAP_BETWEEN_BRICKS), 0.0)
        for r in range(n_rows) for c in range(n_cols)], np.float32)
    brick_scale = (BRICK_SIZE[0], BRICK_SIZE[1], 1.0)
    w.spawn_batch([
        Brick(), Collider(), Sprite(color=BRICK_COLOR, size=(1.0, 1.0)),
        Transform(translation=xyz, scale=brick_scale),
        GlobalTransform(translation=xyz, scale=brick_scale),
    ], len(xyz))
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also time and profile this many frames")
    args = ap.parse_args()
    app = build_app()
    if args.profile:
        run_timed(app, "breakout", profile_frames=args.profile)
    else:
        app.run(max_frames=240, dt=1 / 60.0)
    print("score:", int(app.world.state["res"]["score"]["value"]),
          "bricks left:", app.world.entity_count(Brick))


if __name__ == "__main__":
    main()
