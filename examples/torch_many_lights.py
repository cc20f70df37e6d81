"""many_lights on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/many_lights.py (reference: examples/stress_tests/many_lights.rs —
100k point lights; clustered light binning + per-cluster shading).

Scene: a field of cubes on a huge flattened-cube floor (one shared mesh
keeps the uniform G-buffer path), lit by a grid of tinted point lights.
The frame — time, transform propagation, the G-buffer mesh pass (kernels
B1 and B2, the floor's giant footprint going to B2), light binning and the
deferred shade (kernel B3) — runs eagerly on the device given to
`build_app`.

    python examples/torch_many_lights.py              # 100k lights, ms/frame
    python examples/torch_many_lights.py --profile 10 # + per-span device time
    python examples/torch_many_lights.py --shards 4   # shade in 4 row bands
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.parallel import make_mesh  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.deferred import (  # noqa: E402
    DeferredLightingPlugin, PointLight,
)
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, MeshMaterial, Mesh3dPlugin,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)


def build_app(n_lights=100_000, n_cubes=1024, width=1280, height=720,
              capacity=None, backend="auto", max_lights_per_tile=512,
              light_range=6.0, camera=(0.0, 50.0, 90.0),
              pairs_per_light=3, shards=None, device="cuda") -> App:
    """shards: None, a CUDA card count or a ShardMesh — the deferred shade
    then runs in row bands over those devices."""
    # capacity sized to the scene, as the JAX example (the binning pair
    # arrays and every pool-wide op scale with it)
    cap = capacity or ((n_lights + n_cubes + 1031) // 8 * 8)
    app = App(capacity=cap, device=device)
    plugin = Mesh3dPlugin(backend=backend, deferred=True)
    cube_id = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    DeferredLightingPlugin(
                        pairs_per_light=pairs_per_light,
                        max_lights_per_tile=max_lights_per_tile,
                        shards=shards))
    app.insert_resource(AmbientLight(brightness=0.02))

    app.world.spawn(Camera3d(), *transform_bundle(
        translation=camera,
        rotation=(-0.26, 0.0, 0.0, 0.966)))  # pitch down ~30°
    app.world.spawn(DirectionalLight(illuminance=0.1),
                    *transform_bundle(rotation=(-0.38, 0.0, 0.0, 0.925)))

    # floor: one flattened cube instance (keeps the mesh set uniform)
    app.world.spawn(
        Mesh3d(mesh=cube_id),
        MeshMaterial(base_color=(0.35, 0.35, 0.38, 1.0)),
        *transform_bundle(translation=(0.0, -0.55, 0.0),
                          scale=(400.0, 1.0, 400.0)))

    # cube field
    side_c = int(np.ceil(np.sqrt(n_cubes)))
    ic = np.arange(n_cubes)
    cxyz = np.stack([(ic % side_c - side_c / 2) * 6.0,
                     np.full(n_cubes, 0.5),
                     (ic // side_c - side_c / 2) * 6.0], 1).astype(np.float32)
    app.world.spawn_batch([
        Mesh3d(mesh=cube_id),
        MeshMaterial(base_color=(0.8, 0.8, 0.8, 1.0)),
        Transform(translation=cxyz),
        GlobalTransform(translation=cxyz),
    ], n_cubes)

    # light grid hovering above the floor
    side = max(1, int(np.ceil(np.sqrt(n_lights))))
    il = np.arange(n_lights)
    spacing = 380.0 / side
    lxyz = np.stack([(il % side - side / 2) * spacing,
                     np.full(n_lights, 1.5),
                     (il // side - side / 2) * spacing], 1).astype(np.float32)
    tint = np.stack([0.5 + 0.5 * np.sin(il * 0.3),
                     0.5 + 0.5 * np.sin(il * 0.31 + 2),
                     0.5 + 0.5 * np.sin(il * 0.37 + 4)], 1).astype(np.float32)
    app.world.spawn_batch([
        PointLight(color=tint, intensity=3.0, range=light_range),
        Transform(translation=lxyz),
        GlobalTransform(translation=lxyz),
    ], n_lights)
    return app


def main():
    import argparse

    from torch_many_cubes import profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="N shards, all on the first card (parallel/)")
    args = ap.parse_args()
    app = build_app(shards=make_mesh(devices=["cuda"] * args.shards)
                    if args.shards else None)
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
    print(f"many_lights {app.world.entity_count(PointLight)} on "
          f"{torch.cuda.get_device_name(0)}, {args.shards or 'no'} shade "
          f"bands: {ms:.3f} ms/frame; "
          f"render_stats after {n + 3} frames {stats}")
    if args.profile:
        profile(step, state, args.profile)


if __name__ == "__main__":
    main()
