"""depth_of_field on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/depth_of_field.py (reference: examples/3d/depth_of_field.rs).

The JAX example's five spheres receding from the camera, focused at 4
world units: DepthOfFieldPlugin blends the colour with one and two
separable gaussian blurs by the circle of confusion (render/post.py).

    python examples/torch_depth_of_field.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.post import DepthOfFieldPlugin  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, focal_distance=4.0,
              device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin()
    sphere = plugin.add_mesh(uv_sphere(0.5, 20, 14))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    DepthOfFieldPlugin(focal_distance=focal_distance,
                                       focal_range=1.5, max_blur=2))
    app.insert_resource(AmbientLight(brightness=0.3))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 0.6, 0)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    for i in range(5):
        hue = i / 4.0
        app.world.spawn(
            Mesh3d(mesh=sphere),
            MeshMaterial(base_color=(0.9 - 0.5 * hue, 0.3 + 0.5 * hue, 0.4,
                                     1.0)),
            *transform_bundle(translation=((i - 2) * 0.8, 0.0,
                                           -2.0 - i * 2.0)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "depth_of_field 5 spheres @1280x720")


if __name__ == "__main__":
    main()
