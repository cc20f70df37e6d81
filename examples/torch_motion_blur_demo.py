"""motion_blur_demo on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/motion_blur_demo.py (reference: examples/3d/motion_blur.rs).

The JAX example's racer: a cube ping-ponging fast over a slab, with
per-object motion vectors from the mesh pass
(Mesh3dPlugin(motion_vectors=True)) and MotionBlurPlugin(strength=0.8,
taps=4) sampling along them (render/post.py).

    python examples/torch_motion_blur_demo.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Res, Update, With  # noqa: E402
from bevy_tpu_torch.ecs.component import component  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.post import MotionBlurPlugin  # noqa: E402
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, transform_bundle,
)


@component
class Racer:
    pass


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin(motion_vectors=True)
    cube = plugin.add_mesh(cuboid(0.8, 0.5, 0.5))
    slab = plugin.add_mesh(cuboid(8.0, 0.2, 3.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    MotionBlurPlugin(strength=0.8, taps=4))
    app.insert_resource(AmbientLight(brightness=0.3))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 1.5, 6)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(Mesh3d(mesh=slab),
                    MeshMaterial(base_color=(0.4, 0.4, 0.45, 1.0)),
                    *transform_bundle(translation=(0.0, -0.6, 0.0)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.95, 0.3, 0.1, 1.0)),
                    Racer(), *transform_bundle(translation=(-3.0, 0, 0)))

    @system
    def race(q=Query(Transform, With(Racer)), time=Res(Time)):
        # a fast ping-pong: a strong per-object velocity
        tr = q.transform.translation
        x = (3.0 * torch.sin(time.elapsed * 4.0)).expand(tr.shape[0], 1)
        q.transform.translation = torch.cat([x, tr[:, 1:]], 1)

    app.add_systems(Update, race)
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "motion_blur_demo @1280x720")


if __name__ == "__main__":
    main()
