"""split_screen on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/split_screen.py (reference: examples/3d/split_screen.rs — four
cameras on quarter viewports around one scene; Camera::viewport and
Camera::order).

Four Camera3d on quarter viewports, in ascending `order`, around a
spinning cube, a sphere and a ground plane: the group route's mesh pass
runs once a camera, each pass's NDC mapped onto its viewport rect and
kernels B1 (its scissor instantiation) and B2 scissored to it, every
camera row gathered on the device (no host read a camera).

    python examples/torch_split_screen.py              # 1280x720
    python examples/torch_split_screen.py --profile 10 # + spans
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
from bevy_tpu_torch.math.quat import quat_from_euler  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid, plane, uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, transform_bundle,
)

VIEWS = (((0.0, 0.0), (0.5, 0.5), (0.0, 2.5, 6.0)),
         ((0.5, 0.0), (1.0, 0.5), (6.0, 2.5, 0.0)),
         ((0.0, 0.5), (0.5, 1.0), (0.0, 2.5, -6.0)),
         ((0.5, 0.5), (1.0, 1.0), (-6.0, 2.5, 0.0)))


@system
def spin(q=Query(Transform, With(Mesh3d)), time=Res(Time)):
    z = torch.zeros_like(time.elapsed)
    rot = quat_from_euler(time.elapsed * 0.7, z, z)
    q.transform.rotation = torch.where(q.mask[:, None], rot,
                                       q.transform.rotation)


def look_at_origin(eye):
    """xyzw rotation turning -z toward the origin from `eye`."""
    eye = np.asarray(eye, np.float32)
    yaw = float(np.arctan2(eye[0], eye[2]))
    pitch = float(-np.arctan2(eye[1], max(np.hypot(eye[0], eye[2]), 1e-6)))
    q = quat_from_euler(torch.tensor(yaw), torch.tensor(pitch),
                        torch.tensor(0.0))
    return tuple(float(v) for v in q)


def build_app(width=1280, height=720, backend="auto", capacity=64,
              device="cuda") -> App:
    app = App(capacity=capacity, device=device)
    plugin = Mesh3dPlugin(backend=backend)
    cube = plugin.add_mesh(cuboid(1.2, 1.2, 1.2))
    ball = plugin.add_mesh(uv_sphere(0.8, 10, 14))
    ground = plugin.add_mesh(plane(8.0, 8.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    for i, (mn, mx, eye) in enumerate(VIEWS):
        app.world.spawn(Camera3d(order=i, vp_min=mn, vp_max=mx),
                        *transform_bundle(translation=eye,
                                          rotation=look_at_origin(eye)))
    app.world.spawn(Mesh3d(mesh=ground),
                    MeshMaterial(base_color=(0.35, 0.6, 0.35, 1.0)),
                    *transform_bundle(translation=(0.0, -1.2, 0.0)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.9, 0.25, 0.2, 1.0)),
                    *transform_bundle())
    app.world.spawn(Mesh3d(mesh=ball),
                    MeshMaterial(base_color=(0.2, 0.35, 0.9, 1.0)),
                    *transform_bundle(translation=(1.8, 0.0, -1.0)))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(
                        rotation=look_at_origin((2.0, 4.0, 3.0))))
    app.add_systems(Update, spin)
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "split_screen 4 cameras @1280x720")


if __name__ == "__main__":
    main()
