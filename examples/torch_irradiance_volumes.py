"""irradiance_volumes on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/irradiance_volumes.py (reference: examples/3d/
irradiance_volumes.rs).

The JAX example's floor and four cubes inside a 4 x 1 x 4 ambient-cube
grid (a warm corner fading to cool), a point light, deferred (G-buffer
on kernels B1 and B2, shade on B3); IrradianceVolumePlugin adds the
grid's trilinear diffuse light over the G-buffer (render/irradiance.py).

    python examples/torch_irradiance_volumes.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.deferred import (  # noqa: E402
    DeferredLightingPlugin, PointLight,
)
from bevy_tpu_torch.render.irradiance import (  # noqa: E402
    IrradianceVolumePlugin,
)
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def voxels():
    """The JAX example's (4, 1, 4, 6, 3) ambient cubes."""
    vox = np.zeros((4, 1, 4, 6, 3), np.float32)
    for i in range(4):
        for k in range(4):
            warm = max(0.0, 1.5 - 0.6 * (i + k))
            vox[i, 0, k, :, 0] = 0.15 + warm
            vox[i, 0, k, :, 1] = 0.18 + warm * 0.55
            vox[i, 0, k, :, 2] = 0.35
    return vox


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=32, device=device)
    plugin = Mesh3dPlugin(deferred=True)
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    DeferredLightingPlugin(),
                    IrradianceVolumePlugin(voxels(),
                                           min_corner=(-6.0, -2.0, -9.0),
                                           max_corner=(6.0, 2.0, 3.0)))
    app.insert_resource(AmbientLight(brightness=0.05))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.7, 0.7, 0.72, 1.0),
                                 perceptual_roughness=0.95),
                    *transform_bundle(translation=(0.0, -0.55, -3.0),
                                      scale=(14.0, 0.1, 14.0)))
    for i in range(4):
        app.world.spawn(Mesh3d(mesh=cube),
                        MeshMaterial(base_color=(0.85, 0.85, 0.85, 1.0),
                                     perceptual_roughness=0.9),
                        *transform_bundle(
                            translation=(-4.5 + 3.0 * i, 0.0, -3.0)))
    app.world.spawn(PointLight(intensity=0.8, range=20.0),
                    *transform_bundle(translation=(0.0, 3.0, 0.0)))
    app.world.spawn(Camera3d(), *transform_bundle(
        translation=(0.0, 3.0, 3.0), rotation=(-0.3, 0.0, 0.0, 0.954)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "irradiance_volumes @1280x720")


if __name__ == "__main__":
    main()
