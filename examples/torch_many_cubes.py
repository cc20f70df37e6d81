"""many_cubes on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/many_cubes.py (reference: examples/stress_tests/many_cubes.rs —
cube-grid layout, deterministic orbiting camera in --benchmark mode).

The frame — time, orbit camera, transform propagation, instance frustum
cull, vertex transform, cluster cull, plane setup, window decomposition,
the window-splat (B1) and streaming-tile (B2) CUDA kernels and the flat
resolve — runs eagerly on the device given to `build_app`. With
`backend="xla"` the mesh pass takes the general route instead (the
JAX package's forward route on a GPU): every cube's triangles through
the near-plane clip, triangle setup, tile binning and the per-tile
triangle raster B7.

    python examples/torch_many_cubes.py              # 160k cubes, ms/frame
    python examples/torch_many_cubes.py --profile 10 # + per-span device time
    python examples/torch_many_cubes.py --shards 4   # mesh pass over 4 shards
    python examples/torch_many_cubes.py --backend xla  # the general route
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Res, Update, With  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.math.quat import quat_from_euler  # noqa: E402
from bevy_tpu_torch.parallel import make_mesh  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, Mesh3d, MeshMaterial, Mesh3dPlugin,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)


@system
def orbit_camera(q=Query(Transform, With(Camera3d)), time=Res(Time)):
    """ref: many_cubes.rs --benchmark deterministic camera orbit."""
    t = time.elapsed * 0.2
    radius = 60.0
    height = torch.full_like(t, 12.0)
    eye = torch.stack([torch.sin(t) * radius, height, torch.cos(t) * radius])
    # look-at center: yaw to face origin, slight pitch down
    yaw = torch.atan2(eye[0], eye[2])
    pitch = -torch.atan2(height, torch.full_like(t, radius))
    rot = quat_from_euler(yaw, pitch, torch.zeros_like(t))
    q.transform.translation = torch.where(q.mask[:, None], eye,
                                          q.transform.translation)
    q.transform.rotation = torch.where(q.mask[:, None], rot,
                                       q.transform.rotation)


def build_app(n_cubes=160_000, width=1280, height=720, capacity=None,
              max_per_tile=3072, pairs_per_tri=2, backend="auto",
              tile_h=16, tile_w=128, window_budget=131072,
              eval_tris=8, cull_budget=65536, shards=None,
              occlusion_cull=False, phase_budget=16384,
              device="cuda") -> App:
    """shards: None, a CUDA card count or a ShardMesh — the mesh pass then
    rasters over those devices (parallel/raster.py). occlusion_cull:
    two-phase occlusion culling, at most phase_budget clusters a phase
    (the instance cull then stays off, as in the JAX package); the JAX
    default of 16,384 is below the frame's ~55k visible cubes, so a full
    frame needs about the cube count."""
    # size the world to the scene (+ a little headroom), as the JAX example
    cap = capacity or ((n_cubes + 4103) // 8 * 8)
    app = App(capacity=cap, device=device)
    # cull_budget: instance-level frustum cull compacts to <=64k cubes
    # before the vertex stage
    if cull_budget is not None and cull_budget >= n_cubes:
        cull_budget = None
    plugin = Mesh3dPlugin(max_per_tile=max_per_tile, tile_h=tile_h,
                          tile_w=tile_w, window_budget=window_budget,
                          eval_tris=eval_tris, cull_budget=cull_budget,
                          pairs_per_tri=pairs_per_tri, backend=backend,
                          shards=shards, occlusion_cull=occlusion_cull,
                          phase_budget=phase_budget)
    cube_id = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    app.add_systems(Update, orbit_camera)

    app.world.spawn(Camera3d(),
                    *transform_bundle(translation=(0.0, 12.0, 60.0)))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(
                        rotation=(-0.3826834, 0.0, 0.0, 0.9238795)))

    # cube grid (ref: many_cubes.rs cube layout)
    side = int(np.ceil(n_cubes ** (1 / 3)))
    idx = np.arange(n_cubes)
    spacing = 2.5
    gx = (idx % side - side / 2) * spacing
    gy = (idx // side % side - side / 2) * spacing
    gz = (idx // (side * side) - side / 2) * spacing
    xyz = np.stack([gx, gy, gz], 1).astype(np.float32)
    tint = np.stack([
        0.5 + 0.5 * np.sin(idx * 0.37),
        0.5 + 0.5 * np.sin(idx * 0.53 + 2.0),
        0.5 + 0.5 * np.sin(idx * 0.71 + 4.0),
        np.ones(n_cubes),
    ], 1).astype(np.float32)
    app.world.spawn_batch([
        Mesh3d(mesh=cube_id),
        MeshMaterial(base_color=tint),
        Transform(translation=xyz),
        GlobalTransform(translation=xyz),
    ], n_cubes)
    return app


SPANS = ("system:", "mesh:", "lights:", "sprite:", "skin:",
         "shadow:", "gizmo:", "tilemap:", "transmission:")  # profiler spans
# spans also summed over every kernel inside
OUTER = ("shadow:", "transmission:")


def profile_frames(step, state, frames):
    """torch.profiler over `frames` frames: returns (state, wall ms of the
    window by CUDA events with the profiler on, the kernel count, {span:
    kernel us} by innermost span, {kernel: (calls, us)}, {outer span:
    (calls, us)} over every kernel inside). Each kernel counts toward the
    innermost span (system:*, mesh:*, lights:*, sprite:*, skin:*,
    shadow:*, gizmo:*, tilemap:*) whose GPU-side range holds it, so the
    ctypes-launched CUDA kernels are attributed too; "(outside spans)"
    holds the others."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(frames):
            state = step(state)
        end.record()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in gpu if e.name.startswith(SPANS)]
    kernels = [e for e in gpu if not e.name.startswith(SPANS)]
    per_span, per_kernel, inclusive = {}, {}, {}
    for k in kernels:
        t0, t1 = k.time_range.start, k.time_range.end
        holders = [s for s in spans
                   if s.time_range.start <= t0 and t1 <= s.time_range.end]
        owner = min(holders, key=lambda s: s.time_range.elapsed_us()).name \
            if holders else "(outside spans)"
        us = k.time_range.elapsed_us()
        per_span[owner] = per_span.get(owner, 0.0) + us
        for name in {s.name for s in holders if s.name.startswith(OUTER)}:
            n, tot = inclusive.get(name, (0, 0.0))
            inclusive[name] = (n + 1, tot + us)
        n, tot = per_kernel.get(k.name, (0, 0.0))
        per_kernel[k.name] = (n + 1, tot + us)
    return (state, start.elapsed_time(end), len(kernels), per_span,
            per_kernel, inclusive)


def profile(step, state, frames):
    """Profiles `frames` frames (profile_frames) and prints the device
    busy share of the window (kernel time / CUDA-event wall time), kernel
    time per span, the shadow:* spans again with every kernel inside them
    (their mesh:* spans too), and the top kernels."""
    state, wall_ms, n_kernels, per_span, per_kernel, inclusive = \
        profile_frames(step, state, frames)
    busy_ms = sum(per_span.values()) / 1000.0
    print(f"profile: {frames} frames, {wall_ms / frames:.3f} ms/frame wall "
          f"(CUDA events, profiler on), kernels {busy_ms / frames:.3f} "
          f"ms/frame = {busy_ms / wall_ms:.1%} busy, "
          f"{n_kernels // frames} kernel launches/frame")
    print("span (kernels in it, innermost)   device ms/frame")
    for name, us in sorted(per_span.items(), key=lambda kv: -kv[1]):
        print(f"{name:<34}{us / 1000 / frames:>15.3f}")
    if inclusive:
        print("span (every kernel inside)        device ms/frame  launches")
        for name, (n, us) in sorted(inclusive.items(),
                                    key=lambda kv: -kv[1][1]):
            print(f"{name:<34}{us / 1000 / frames:>15.3f}"
                  f"{n // frames:>10}")
    print("kernel (top 15)                                     ms/frame  calls")
    for name, (n, us) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][1])[:15]:
        print(f"{name[:50]:<50}{us / 1000 / frames:>10.3f}{n // frames:>7}")
    return state


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="N shards, all on the first card (parallel/)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "pallas", "xla"),
                    help="the mesh pass's route: xla = the general route")
    ap.add_argument("--occlusion", type=int, default=0, metavar="BUDGET",
                    help="two-phase occlusion culling, BUDGET clusters a "
                    "phase (0: off)")
    args = ap.parse_args()
    app = build_app(shards=make_mesh(devices=["cuda"] * args.shards)
                    if args.shards else None, backend=args.backend,
                    occlusion_cull=args.occlusion > 0,
                    phase_budget=args.occlusion or 16384)
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
    print(f"many_cubes {app.world.entity_count(Mesh3d)} on "
          f"{torch.cuda.get_device_name(0)}, backend {args.backend}, "
          f"{args.shards or 'no'} shards: {ms:.3f} ms/frame")
    if args.profile:
        profile(step, state, args.profile)


if __name__ == "__main__":
    main()
