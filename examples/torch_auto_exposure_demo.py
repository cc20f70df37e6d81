"""auto_exposure_demo on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/auto_exposure_demo.py (reference: examples/3d/auto_exposure.rs —
eye adaptation to a changing scene brightness).

The JAX example's sphere under a directional light whose illuminance
swings from 0.1 to 3.9 (a system reading Time.elapsed); AutoExposurePlugin
meters the frame's mean log luminance and eases the exposure towards it
(render/post.py), its EV kept on the device.

    python examples/torch_auto_exposure_demo.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Res, Update  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.post import AutoExposurePlugin  # noqa: E402
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=8, device=device)
    plugin = Mesh3dPlugin()
    sphere = plugin.add_mesh(uv_sphere(0.9, 20, 14))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    AutoExposurePlugin())
    app.insert_resource(AmbientLight(brightness=0.2))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 0, 3)))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(Mesh3d(mesh=sphere),
                    MeshMaterial(base_color=(0.8, 0.8, 0.8, 1.0)),
                    *transform_bundle())

    @system
    def swing_light(q=Query(DirectionalLight), time=Res(Time)):
        # a 0.1x to 4x brightness swing: the exposure follows it
        lum = 2.0 + 1.9 * torch.sin(time.elapsed * 1.5)
        q.directional_light.illuminance = lum.expand(
            q.directional_light.illuminance.shape)

    app.add_systems(Update, swing_light)
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "auto_exposure_demo @1280x720")


if __name__ == "__main__":
    main()
