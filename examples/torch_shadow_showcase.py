"""Shadow showcase on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/shadow_showcase.py (reference: examples/3d/
shadow_caster_receiver.rs + spotlight.rs — cascaded directional shadows
and a shadow-casting spot over the deferred path).

Scene: a floor, three cube casters (one with a specular tint), an
anisotropic metal sphere, a directional light with cascaded shadow maps
and a shadow-casting spot; `--point` adds a shadow-casting point light
(a six-face cube map), `--grid N` an N x N grid of unit cubes on the
floor. The frame — the depth-only shadow passes and the G-buffer pass on
kernels B1 and B2, the cascade lookup, light binning and the deferred
shade (kernel B3) with the shadow plane, then the spot's and the point
light's shadowed terms — runs eagerly on the device given to `build_app`.

    python examples/torch_shadow_showcase.py                 # ms/frame
    python examples/torch_shadow_showcase.py --profile 10    # + spans
    python examples/torch_shadow_showcase.py --point         # the card's

The defaults are 1280x720, 4 x 2048^2 cascades, 1024^2 spot and point
maps and a 100 x 100 grid. A 2048^2 map of only a few casters (a small
`--grid`) overflows the raster's window budget and drops windows, as
the JAX package's does (ROADMAP C3); the run then exits non-zero.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.deferred import (  # noqa: E402
    DeferredLightingPlugin, PointLight, SpotLight,
)
from bevy_tpu_torch.render.mesh import cuboid, uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, MeshMaterial, Mesh3dPlugin,
)
from bevy_tpu_torch.render.point_shadow import PointShadowPlugin  # noqa: E402
from bevy_tpu_torch.render.shadow import ShadowPlugin  # noqa: E402
from bevy_tpu_torch.render.spot_shadow import SpotShadowPlugin  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)

SPOT_AT = (1.0, 5.0, 3.0)
SPOT_ROT = (-0.55, 0.1, 0.05, 0.83)
POINT_AT = (-3.0, 3.0, 1.0)
GRID_SPACING = 2.0


def build_app(width=640, height=360, size=512, cascades=2, extent=16.0,
              distance=30.0, spot_size=512, point=False, point_size=256,
              grid=0, near_casters=False, device="cuda") -> App:
    """The showcase world. size / cascades / extent / distance: the
    directional ShadowPlugin; spot_size, point_size: the spot's map and
    the point light's faces; grid: an N x N grid of unit cubes (2 apart)
    on a floor grown to hold it; near_casters: two small cubes that
    straddle the spot's and the point light's near planes (their
    clusters take the streaming-tile kernel B2 in the shadow passes)."""
    n_grid = grid * grid
    app = App(capacity=n_grid + 16, device=device)
    plugin = Mesh3dPlugin(deferred=True)
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    sphere = plugin.add_mesh(uv_sphere(0.6, 24, 16))
    plugins = [TimePlugin(), TransformPlugin(),
               RenderPlugin(width=width, height=height), plugin,
               DeferredLightingPlugin(),
               ShadowPlugin(plugin, size=size, extent=extent,
                            distance=distance, cascades=cascades),
               SpotShadowPlugin(plugin, size=spot_size)]
    if point:
        plugins.append(PointShadowPlugin(plugin, size=point_size))
    app.add_plugins(*plugins)
    app.insert_resource(AmbientLight(brightness=0.05))
    floor = max(24.0, grid * GRID_SPACING + 8.0)
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.75, 0.75, 0.75, 1.0)),
                    *transform_bundle(translation=(0.0, -0.55, 0.0),
                                      scale=(floor, 0.1, floor)))
    for (x, z), tint in zip(((-2.0, 0.0), (0.0, -1.5), (2.0, 0.5)),
                            ((1.0, 1.0, 1.0), (1.0, 0.55, 0.2),
                             (1.0, 1.0, 1.0))):
        app.world.spawn(Mesh3d(mesh=cube),
                        MeshMaterial(base_color=(0.7, 0.4, 0.3, 1.0),
                                     perceptual_roughness=0.3,
                                     specular_tint=tint),
                        *transform_bundle(translation=(x, 0.5, z)))
    app.world.spawn(Mesh3d(mesh=sphere),
                    MeshMaterial(base_color=(0.8, 0.8, 0.85, 1.0),
                                 metallic=1.0, perceptual_roughness=0.4,
                                 anisotropy_strength=0.7,
                                 anisotropy_rotation=0.5),
                    *transform_bundle(translation=(0.0, 0.6, 1.5)))
    if n_grid:
        i = np.arange(n_grid)
        xyz = np.stack([(i % grid - (grid - 1) / 2) * GRID_SPACING,
                        np.full(n_grid, -0.05),
                        (i // grid - (grid - 1) / 2) * GRID_SPACING],
                       1).astype(np.float32)
        xyz[:, 2] -= GRID_SPACING / 2           # clear of the hero casters
        app.world.spawn_batch([
            Mesh3d(mesh=cube),
            MeshMaterial(base_color=(0.55, 0.6, 0.7, 1.0)),
            Transform(translation=xyz, scale=np.full((n_grid, 3), 0.9,
                                                      np.float32)),
            GlobalTransform(translation=xyz, scale=np.full(
                (n_grid, 3), 0.9, np.float32)),
        ], n_grid)
    app.world.spawn(DirectionalLight(illuminance=0.8),
                    *transform_bundle(rotation=(-0.35, 0.3, 0.1, 0.88)))
    app.world.spawn(SpotLight(intensity=50.0, range=25.0, inner_angle=0.4,
                              outer_angle=0.7, shadows=1),
                    *transform_bundle(translation=SPOT_AT,
                                      rotation=SPOT_ROT))
    if point:
        app.world.spawn(PointLight(color=(1.0, 0.8, 0.6), intensity=30.0,
                                   range=20.0, shadows=1),
                        *transform_bundle(translation=POINT_AT))
    if near_casters:
        # 4 cm cubes across the lights' near planes: 0.1 m along the
        # spot's axis (5 cm to its side), 0.06 m above the point light
        # (its +Y face's near plane at 0.05 m; nothing receives there)
        from bevy_tpu_torch.math.quat import quat_rotate_vec3
        ax = quat_rotate_vec3(torch.tensor(SPOT_ROT),
                              torch.tensor([0.0, 0.0, -1.0])).numpy()
        side = np.cross(ax, [0.0, 1.0, 0.0])
        side /= np.linalg.norm(side)
        at = np.asarray(SPOT_AT) + 0.1 * ax + 0.05 * side
        for pos in [at] + ([np.asarray(POINT_AT) + [0.0, 0.06, 0.0]]
                           if point else []):
            app.world.spawn(Mesh3d(mesh=cube), MeshMaterial(),
                            *transform_bundle(translation=tuple(pos),
                                              scale=(0.04, 0.04, 0.04)))
    app.world.spawn(Camera3d(), *transform_bundle(
        translation=(0.0, 4.0, 9.0), rotation=(-0.2, 0.0, 0.0, 0.98)))
    return app


def main():
    import argparse

    from torch_many_cubes import profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--size", type=int, default=2048,
                    help="the directional cascades' map size")
    ap.add_argument("--cascades", type=int, default=4)
    ap.add_argument("--point", action="store_true",
                    help="add a shadow-casting point light (1024 faces)")
    ap.add_argument("--grid", type=int, default=100, metavar="N",
                    help="an N x N grid of unit cubes as casters")
    args = ap.parse_args()
    app = build_app(width=args.width, height=args.height, size=args.size,
                    cascades=args.cascades, extent=48.0, distance=80.0,
                    spot_size=1024, point=args.point, point_size=1024,
                    grid=args.grid)
    step = app.frame_fn()
    state = app.world.state
    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    n = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    stats = {k: int(v) for k, v in state["res"]["render_stats"].items()}
    print(f"shadow_showcase {app.world.entity_count(Mesh3d)} meshes, "
          f"{args.cascades} x {args.size}^2 cascades, point "
          f"{'on' if args.point else 'off'}, {args.width}x{args.height} on "
          f"{torch.cuda.get_device_name(0)}: {ms:.3f} ms/frame; "
          f"render_stats after {n + 3} frames {stats}")
    if args.profile:
        profile(step, state, args.profile)
    if stats["pair_overflow"] or stats["tile_overflow"]:
        raise SystemExit("the raster overflowed its budgets: shadow maps "
                         "and frame are incomplete")


if __name__ == "__main__":
    main()
