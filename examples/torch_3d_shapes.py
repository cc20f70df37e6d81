"""3d_shapes on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/3d_shapes.py (reference: examples/3d/3d_shapes.rs — one of each
built-in mesher on a turntable under a directional light).

The scene holds six smooth-shaded meshes and a floor plane, so it takes
the mesh pass's general route (`Mesh3dPlugin(backend="xla")`, the route
JAX's "auto" takes for it on a CPU or GPU): per-vertex gathers, near-plane
clip, triangle setup, tile binning and the per-tile triangle raster B7,
eagerly on the device given to `build_app`. `backend="auto"` draws the
same scene on the group route (smooth meshes on the shade records, B1
and B2).

    python examples/torch_3d_shapes.py               # 1280x720, ms/frame
    python examples/torch_3d_shapes.py --profile 10  # + per-span device time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Update  # noqa: E402
from bevy_tpu_torch.ecs.query import Read, Res  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import (  # noqa: E402
    capsule, cone, cuboid, cylinder, plane, torus, uv_sphere,
)
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, MeshMaterial, Mesh3dPlugin,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, transform_bundle,
)


@system
def turntable(q=Query(Transform, Read(Mesh3d)), time=Res(Time)):
    """Spin every shape above the floor about +y at 0.7 rad/s."""
    half = torch.sin(time.elapsed * 0.7 * 0.5)
    zero = torch.zeros_like(half)
    rot = torch.stack([zero, half, zero,
                       torch.cos(time.elapsed * 0.7 * 0.5) *
                       torch.ones_like(half)], -1)
    q.transform.rotation = torch.where(
        (q.transform.translation[:, 1] > 0.5)[:, None], rot,
        q.transform.rotation)


def build_app(width=800, height=450, backend="xla", tile_h=32,
              max_per_tile=256, pairs_per_tri=2, device="cuda") -> App:
    app = App(capacity=64, device=device)
    plugin = Mesh3dPlugin(backend=backend, tile_h=tile_h,
                          max_per_tile=max_per_tile,
                          pairs_per_tri=pairs_per_tri)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    app.insert_resource(AmbientLight(brightness=0.25))
    app.world.spawn(Camera3d(),
                    *transform_bundle(translation=(0.0, 2.2, 9.0),
                                      rotation=(-0.12, 0.0, 0.0, 0.993)))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(rotation=(-0.35, 0.25, 0.0, 0.9)))
    shapes = [cuboid(1.1, 1.1, 1.1), uv_sphere(0.65, 24, 16),
              cylinder(0.55, 1.1), torus(0.45, 0.22),
              cone(0.6, 1.1), capsule(0.45, 0.7)]
    n = len(shapes)
    for i, mesh in enumerate(shapes):
        hue = i / n
        col = (0.5 + 0.5 * np.cos(6.28 * hue),
               0.5 + 0.5 * np.cos(6.28 * (hue + 1 / 3)),
               0.5 + 0.5 * np.cos(6.28 * (hue + 2 / 3)), 1.0)
        app.world.spawn(
            Mesh3d(mesh=plugin.add_mesh(mesh)),
            MeshMaterial(base_color=col, perceptual_roughness=0.4,
                         metallic=0.1),
            *transform_bundle(translation=((i - (n - 1) / 2) * 1.8,
                                           1.0, 0.0)))
    app.world.spawn(
        Mesh3d(mesh=plugin.add_mesh(plane(16.0, 10.0))),
        MeshMaterial(base_color=(0.35, 0.4, 0.45, 1.0),
                     perceptual_roughness=0.95),
        *transform_bundle(translation=(0.0, 0.0, 0.0)))
    app.add_systems(Update, turntable)
    return app


def main():
    import argparse

    from torch_many_cubes import profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    app = build_app(width=1280, height=720)
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
    print(f"3d_shapes @1280x720 on {torch.cuda.get_device_name(0)}: "
          f"{ms:.3f} ms/frame; render_stats after {n + 3} frames {stats}")
    if args.profile:
        profile(step, state, args.profile)


if __name__ == "__main__":
    main()
