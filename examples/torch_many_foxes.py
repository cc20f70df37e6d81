"""many_foxes on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/many_foxes.py (reference: examples/stress_tests/many_foxes.rs —
1000 skinned, animated meshes running a looping clip).

The reference loads the glTF Fox; this twin builds the same procedural
quadruped rig as the JAX example (an 11-joint skeleton, a rigid-skinned
segmented body, a baked run cycle). The frame — time, the clip clocks,
transform propagation, clip sampling, joint composition, skinning, the
window-splat (B1) and streaming-tile (B2) CUDA kernels and the per-pixel
shade-record resolve — runs eagerly on the device given to `build_app`.

    python examples/torch_many_foxes.py              # 1000 foxes, ms/frame
    python examples/torch_many_foxes.py --profile 10 # + per-span device time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.animation import (  # noqa: E402
    AnimationClip, AnimationPlayer, Skeleton,
)
from bevy_tpu_torch.math.quat import quat_from_axis_angle  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import Mesh, cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, MeshMaterial,
)
from bevy_tpu_torch.render.skinned import (  # noqa: E402
    SkinnedMesh3d, SkinnedMeshPlugin,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    GlobalTransform, Transform, TransformPlugin, transform_bundle,
)

X = np.asarray([1.0, 0.0, 0.0])


def _axis_quat(axis, angle):
    """A host quaternion (float32 numpy) about `axis` by `angle`."""
    return quat_from_axis_angle(torch.as_tensor(axis, dtype=torch.float32),
                                float(angle)).numpy()


def build_rig():
    """11-joint quadruped: spine root, chest, head, tail, four legs (the
    front ones in two segments), tail tip; one box segment per bone."""
    #           0 root   1 chest  2 head   3 tail
    #           4 FL leg 5 FR leg 6 BL leg 7 BR leg (single-segment legs)
    #           8 FL low 9 FR low 10 tail tip
    parents = [-1, 0, 1, 0, 1, 1, 0, 0, 4, 5, 3]
    rest_t = np.asarray([
        [0.0, 0.9, 0.0],     # root (hips) above ground
        [0.0, 0.0, 0.6],     # chest forward (+z forward)
        [0.0, 0.25, 0.45],   # head
        [0.0, 0.1, -0.5],    # tail base
        [-0.25, -0.1, 0.1],  # front-left hip
        [0.25, -0.1, 0.1],   # front-right hip
        [-0.25, -0.1, -0.1],  # back-left hip
        [0.25, -0.1, -0.1],  # back-right hip
        [0.0, -0.45, 0.0],   # front-left knee
        [0.0, -0.45, 0.0],   # front-right knee
        [0.0, 0.0, -0.4],    # tail tip
    ], np.float32)
    skeleton = Skeleton(parents, rest_t)

    # rigid-skinned box segment per bone: (bone, size, offset)
    segs = [
        (0, (0.5, 0.5, 0.7), (0.0, 0.0, 0.0)),    # hips
        (1, (0.55, 0.55, 0.7), (0.0, 0.0, 0.1)),  # chest
        (2, (0.35, 0.35, 0.45), (0.0, 0.05, 0.1)),  # head
        (3, (0.15, 0.15, 0.45), (0.0, 0.0, -0.2)),  # tail
        (4, (0.14, 0.5, 0.14), (0.0, -0.2, 0.0)),
        (5, (0.14, 0.5, 0.14), (0.0, -0.2, 0.0)),
        (6, (0.14, 0.5, 0.14), (0.0, -0.2, 0.0)),
        (7, (0.14, 0.5, 0.14), (0.0, -0.2, 0.0)),
        (8, (0.12, 0.5, 0.12), (0.0, -0.25, 0.0)),
        (9, (0.12, 0.5, 0.12), (0.0, -0.25, 0.0)),
        (10, (0.1, 0.1, 0.35), (0.0, 0.0, -0.15)),
    ]
    gt, _, _ = skeleton.rest_global()
    pos, nrm, tris, weights = [], [], [], []
    for bone, size, off in segs:
        box = cuboid(*size)
        base = len(pos)
        p = box.positions + np.asarray(off, np.float32) + gt[bone]
        pos += list(p)
        nrm += list(box.normals)
        tris += list(box.triangles + base)
        w = np.zeros((box.num_vertices, skeleton.num_joints), np.float32)
        w[:, bone] = 1.0
        weights += list(w)
    mesh = Mesh(pos, nrm, np.zeros((len(pos), 2), np.float32), tris)
    return skeleton, mesh, np.asarray(weights, np.float32)


def run_clip(skeleton: Skeleton, duration=0.8, rate=30.0) -> AnimationClip:
    """A run cycle: legs swing in diagonal pairs, spine bobs, tail wags."""
    j = skeleton.num_joints

    def pose(t):
        ph = 2 * np.pi * t / duration
        r = np.tile([0, 0, 0, 1.0], (j, 1)).astype(np.float32)
        tr = skeleton.rest_t.copy()
        swing = 0.7 * np.sin(ph)
        r[4] = _axis_quat(X, swing)          # FL
        r[5] = _axis_quat(X, -swing)         # FR
        r[6] = _axis_quat(X, -swing)         # BL
        r[7] = _axis_quat(X, swing)          # BR
        r[8] = _axis_quat(X, 0.5 * max(0.0, np.sin(ph)))
        r[9] = _axis_quat(X, 0.5 * max(0.0, -np.sin(ph)))
        r[2] = _axis_quat(X, 0.1 * np.sin(2 * ph))       # head nod
        r[10] = _axis_quat([0, 1, 0], 0.4 * np.sin(2 * ph))  # tail wag
        tr[0, 1] += 0.08 * abs(np.sin(2 * ph))           # body bob
        return {"translation": tr, "rotation": r}

    return AnimationClip(duration, pose, rate)


def build_app(n_foxes=1000, width=1280, height=720, capacity=None,
              max_per_tile=512, camera=(0.0, 20.0, 60.0), camera_pitch=-0.3,
              device=None) -> App:
    """device: None for the CUDA card, or a torch device ("cpu" in
    tests)."""
    cap = capacity or 1
    while cap < n_foxes + 8:
        cap *= 2
    app = App(capacity=cap, device="cuda" if device is None else device)
    skeleton, mesh, weights = build_rig()
    clip = run_clip(skeleton)
    plugin = SkinnedMeshPlugin(skeleton, mesh, weights, [clip],
                               max_per_tile=max_per_tile)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)

    app.world.spawn(Camera3d(), *transform_bundle(
        translation=camera,
        rotation=tuple(_axis_quat(X, camera_pitch))))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(rotation=tuple(_axis_quat(X, -0.9))))

    side = int(np.ceil(np.sqrt(n_foxes)))
    idx = np.arange(n_foxes)
    spacing = 3.0
    xyz = np.stack([(idx % side - side / 2) * spacing,
                    np.zeros(n_foxes),
                    (idx // side - side / 2) * spacing], 1).astype(np.float32)
    phase = (idx % 37).astype(np.float32) / 37.0 * 0.8
    tint = np.stack([0.7 + 0.3 * np.sin(idx * 0.1),
                     0.45 + 0.2 * np.sin(idx * 0.17 + 1),
                     0.15 + 0.1 * np.sin(idx * 0.23 + 2),
                     np.ones(n_foxes)], 1).astype(np.float32)
    app.world.spawn_batch([
        SkinnedMesh3d(),
        AnimationPlayer(time=phase),
        MeshMaterial(base_color=tint),
        Transform(translation=xyz),
        GlobalTransform(translation=xyz),
    ], n_foxes)
    return app


def main():
    import argparse

    from torch_many_cubes import profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    app = build_app()
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
    print(f"many_foxes {app.world.entity_count(SkinnedMesh3d)} on "
          f"{torch.cuda.get_device_name(0)}: {ms:.3f} ms/frame")
    if args.profile:
        profile(step, state, args.profile)


if __name__ == "__main__":
    main()
