"""alien_cake_addict on bevy_tpu_torch — the PyTorch twin of
examples/alien_cake_addict.py (reference: examples/showcase/
alien_cake_addict.rs — "Eat the cakes. Eat them all.": arrow-key movement
with a cooldown, timed cake spawns, a score and a Playing / GameOver
state with restart).

Each frame goes through InputPlugin's frame inputs (one host-to-device
copy), the game's host systems (its logic keeps a Python dict, as the
reference's example does, and moves entities with `World.set_field`),
transform propagation and the mesh pass's group route: flat Lambert +
a directional light, the window raster B1 and the tile raster B2. The one
cake is parked under the board when none is live, as the JAX example does.

    python examples/torch_alien_cake_addict.py      # 1280x720, 200 frames
    python examples/torch_alien_cake_addict.py --frames 400 --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Update  # noqa: E402
from bevy_tpu_torch.ecs.component import component  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.input import InputPlugin, KeyCode  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid, uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, MeshMaterial, Mesh3dPlugin,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, transform_bundle,
)

BOARD = 8
MOVE_COOLDOWN = 0.18
CAKE_PERIOD = 3.0        # ref: BonusSpawnTimer 5s, shortened for demos
ARROWS = (KeyCode.ArrowUp, KeyCode.ArrowDown, KeyCode.ArrowLeft,
          KeyCode.ArrowRight)


class GameState:
    PLAYING = 0
    GAME_OVER = 1


@component
class PlayerTag:
    pass


@component
class CakeTag:
    pass


def _heights(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.random((BOARD, BOARD)) * 0.25).astype(np.float32)


def build_app(width=1280, height=720, backend="auto", seed=4, device="cuda",
              **plugin_kw):
    app = App(capacity=128, device=device)
    plugin = Mesh3dPlugin(backend=backend, **plugin_kw)
    tile = plugin.add_mesh(cuboid(0.9, 0.3, 0.9))
    body = plugin.add_mesh(cuboid(0.5, 0.8, 0.5))
    cake_mesh = plugin.add_mesh(uv_sphere(0.28, 12, 8))
    app.add_plugins(TimePlugin(), TransformPlugin(), InputPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    app.insert_resource(AmbientLight(brightness=0.3))
    app.world.spawn(Camera3d(),
                    *transform_bundle(translation=(BOARD / 2 - 0.5, 7.0,
                                                   BOARD + 3.0),
                                      rotation=(-0.33, 0.0, 0.0, 0.944)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.4, 0.2, 0.0, 0.9)))
    hts = _heights(seed)
    for i in range(BOARD):
        for j in range(BOARD):
            g = 0.55 + 0.25 * ((i + j) % 2)
            app.world.spawn(
                Mesh3d(mesh=tile),
                MeshMaterial(base_color=(0.2 * g, 0.8 * g, 0.3 * g, 1.0)),
                *transform_bundle(translation=(i, hts[i, j], j)))
    player = app.world.spawn(
        Mesh3d(mesh=body),
        MeshMaterial(base_color=(0.85, 0.3, 0.6, 1.0)), PlayerTag(),
        *transform_bundle(translation=(BOARD // 2,
                                       hts[BOARD // 2, BOARD // 2] + 0.55,
                                       BOARD // 2)))
    # one cake entity, parked under the board while no cake is live
    cake = app.world.spawn(
        Mesh3d(mesh=cake_mesh),
        MeshMaterial(base_color=(0.95, 0.8, 0.2, 1.0),
                     emissive=(0.4, 0.3, 0.05)), CakeTag(),
        *transform_bundle(translation=(0.0, -5.0, 0.0)))
    game = {"i": BOARD // 2, "j": BOARD // 2, "score": 0,
            "cooldown": 0.0, "cake": None, "cake_timer": 0.0,
            "cake_i": -1, "cake_j": -1, "rng": np.random.default_rng(seed),
            "player": player, "cake_ent": cake, "hts": hts,
            "over": False, "state": GameState.PLAYING}
    app._game = game

    @system(host=True)
    def playing(world):
        """Host game logic (ref: move_player + spawn_bonus +
        scoreboard_system under run_if(in_state(Playing)))."""
        g = app._game
        if g["state"] != GameState.PLAYING:
            return
        dt = 1.0 / 60.0
        g["cooldown"] = max(0.0, g["cooldown"] - dt)
        keys = app.input.keys
        if g["cooldown"] <= 0.0:
            di = dj = 0
            if keys[KeyCode.ArrowUp]:
                dj = -1
            elif keys[KeyCode.ArrowDown]:
                dj = 1
            elif keys[KeyCode.ArrowLeft]:
                di = -1
            elif keys[KeyCode.ArrowRight]:
                di = 1
            if di or dj:
                g["i"] = int(np.clip(g["i"] + di, 0, BOARD - 1))
                g["j"] = int(np.clip(g["j"] + dj, 0, BOARD - 1))
                g["cooldown"] = MOVE_COOLDOWN
                world.set_field(g["player"], Transform, "translation",
                                np.asarray([g["i"],
                                            g["hts"][g["i"], g["j"]] + 0.55,
                                            g["j"]], np.float32))
        # cake spawn / decay (ref: spawn_bonus — an uneaten cake costs 3
        # points and game-overs below zero)
        g["cake_timer"] += dt
        if g["cake_timer"] >= CAKE_PERIOD:
            g["cake_timer"] = 0.0
            if g["cake"] is not None:
                g["score"] -= 3
                g["cake"] = None
                if g["score"] < 0:
                    g["over"] = True
                    g["state"] = GameState.GAME_OVER
                    world.set_field(g["cake_ent"], Transform, "translation",
                                    np.asarray([0, -5.0, 0], np.float32))
                    return
            ci = int(g["rng"].integers(0, BOARD))
            cj = int(g["rng"].integers(0, BOARD))
            g["cake_i"], g["cake_j"] = ci, cj
            g["cake"] = True
            world.set_field(g["cake_ent"], Transform, "translation",
                            np.asarray([ci, g["hts"][ci, cj] + 0.65, cj],
                                       np.float32))
        # eat (ref: the Playing update's cake collision)
        if g["cake"] is not None and (g["i"], g["j"]) == \
                (g["cake_i"], g["cake_j"]):
            g["cake"] = None
            g["score"] += 2
            world.set_field(g["cake_ent"], Transform, "translation",
                            np.asarray([0, -5.0, 0], np.float32))

    @system(host=True)
    def game_over(world):
        """ref: game_over_keyboard — Space restarts."""
        g = app._game
        if g["state"] != GameState.GAME_OVER:
            return
        if app.input.keys[KeyCode.Space]:
            g["score"] = 0
            g["over"] = False
            g["state"] = GameState.PLAYING

    app.add_systems(Update, [playing, game_over])
    return app


def steer(app):
    """The scripted chase (the JAX example's and its test's): release the
    arrows, then press toward the live cake, columns first."""
    g = app._game
    for k in ARROWS:
        app.input.release(k)
    if g["cake"] is not None:
        if g["cake_i"] > g["i"]:
            app.input.press(KeyCode.ArrowRight)
        elif g["cake_i"] < g["i"]:
            app.input.press(KeyCode.ArrowLeft)
        elif g["cake_j"] > g["j"]:
            app.input.press(KeyCode.ArrowDown)
        elif g["cake_j"] < g["j"]:
            app.input.press(KeyCode.ArrowUp)


def trajectory_row(app):
    """(player i, player j, cake i, cake j or -1 without a live cake,
    score) after a frame."""
    g = app._game
    live = g["cake"] is not None
    return (g["i"], g["j"], g["cake_i"] if live else -1,
            g["cake_j"] if live else -1, g["score"])


def play(app, frames):
    """`frames` frames of the chase; returns the trajectory rows."""
    rows = []
    for _ in range(frames):
        steer(app)
        app.update(dt=1 / 60)
        rows.append(trajectory_row(app))
    return rows


def main():
    import argparse

    from torch_ecs_run import dtoh_records
    from torch_many_cubes import profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    app = build_app(width=args.width, height=args.height)
    play(app, 3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rows = play(app, args.frames - 3)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / max(args.frames - 3, 1)
    stats = {k: int(v) for k, v in
             app.world.state["res"]["render_stats"].items()}
    print(f"alien_cake_addict @{args.width}x{args.height} on "
          f"{torch.cuda.get_device_name(0)}: score {rows[-1][4]} after "
          f"{args.frames} frames, {ms:.3f} ms/frame; render_stats {stats}")
    if args.profile:
        def step(state):
            app.world.state = state
            steer(app)
            app.update(dt=1 / 60)
            return app.world.state
        from torch.profiler import ProfilerActivity, profile as torch_profile
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            step(app.world.state)
            torch.cuda.synchronize()
        print(f"one frame: {dtoh_records(prof)} Memcpy DtoH records")
        profile(step, app.world.state, args.profile)


if __name__ == "__main__":
    main()
