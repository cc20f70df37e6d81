"""decals on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/decals.py (reference: examples/3d/decal.rs — clustered decals).

The JAX example's floor and back wall with three coloured box projectors
on the floor, deferred: the G-buffer pass on kernels B1 and B2, then
DecalPlugin stamps the decals into the G-buffer albedo (render/decal.py)
before the shade on B3.

    python examples/torch_decals.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.decal import Decal, DecalPlugin  # noqa: E402
from bevy_tpu_torch.render.deferred import (  # noqa: E402
    DeferredLightingPlugin,
)
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=32, device=device)
    plugin = Mesh3dPlugin(deferred=True)
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    DecalPlugin(), DeferredLightingPlugin())
    app.insert_resource(AmbientLight(brightness=0.3))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.75, 0.75, 0.78, 1.0)),
                    *transform_bundle(translation=(0.0, -0.55, -3.0),
                                      scale=(14.0, 0.1, 14.0)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.6, 0.62, 0.66, 1.0)),
                    *transform_bundle(translation=(0.0, 2.0, -8.0),
                                      scale=(14.0, 6.0, 0.2)))
    for x, col in ((-3.0, (1.0, 0.15, 0.1, 0.9)),
                   (0.0, (0.1, 0.9, 0.2, 0.9)),
                   (3.0, (0.2, 0.3, 1.0, 0.9))):
        app.world.spawn(Decal(color=col),
                        *transform_bundle(translation=(x, -0.4, -3.0),
                                          scale=(2.0, 1.2, 2.0)))
    app.world.spawn(DirectionalLight(illuminance=0.8),
                    *transform_bundle(rotation=(-0.38, 0.0, 0.0, 0.92)))
    app.world.spawn(Camera3d(), *transform_bundle(
        translation=(0.0, 4.0, 4.0), rotation=(-0.35, 0.0, 0.0, 0.94)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "decals 3 projectors @1280x720")


if __name__ == "__main__":
    main()
