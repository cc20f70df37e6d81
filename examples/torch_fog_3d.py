"""fog_3d on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/fog_3d.py (reference: examples/3d/fog.rs, volumetric_fog.rs).

The JAX example's receding colonnade (16 cubes and a floor) through
distance fog and a 16-step volumetric fog march (render/fog.py);
`--shadows` adds cascaded shadow maps (render/shadow.py), which gate the
march's in-scattering (god rays) and need the deferred path.

    python examples/torch_fog_3d.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.deferred import (  # noqa: E402
    DeferredLightingPlugin,
)
from bevy_tpu_torch.render.fog import (  # noqa: E402
    DistanceFogPlugin, VolumetricFogPlugin,
)
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.shadow import ShadowPlugin  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, volumetric=True, shadows=False,
              device="cuda") -> App:
    app = App(capacity=64, device=device)
    plugin = Mesh3dPlugin(deferred=shadows)
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    fog = [DistanceFogPlugin(color=(0.35, 0.4, 0.5), density=0.05)]
    if volumetric:
        fog.append(VolumetricFogPlugin(density=0.04))
    lit = [DeferredLightingPlugin(),
           ShadowPlugin(plugin, size=1024, extent=24.0, distance=40.0,
                        cascades=2)] if shadows else []
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin, *lit,
                    *fog)
    app.insert_resource(AmbientLight(brightness=0.15))
    for i in range(8):
        for sx in (-2.5, 2.5):
            app.world.spawn(
                Mesh3d(mesh=cube),
                MeshMaterial(base_color=(0.8, 0.3 + 0.08 * i, 0.2, 1.0)),
                *transform_bundle(translation=(sx, 0.0, -3.0 * i),
                                  scale=(1.0, 2.0, 1.0)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.4, 0.42, 0.45, 1.0)),
                    *transform_bundle(translation=(0.0, -1.6, -12.0),
                                      scale=(30.0, 0.2, 40.0)))
    app.world.spawn(DirectionalLight(illuminance=1.2),
                    *transform_bundle(rotation=(-0.35, 0.25, 0.0, 0.9)))
    app.world.spawn(Camera3d(), *transform_bundle(
        translation=(0.0, 1.5, 4.0), rotation=(-0.08, 0.0, 0.0, 0.997)))
    return app


def main():
    import argparse

    from torch_post_processing import twin_main

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--shadows", action="store_true")
    shadows = ap.parse_known_args()[0].shadows
    twin_main(__doc__, build_app,
              f"fog_3d{' + shadow maps' if shadows else ''} @1280x720",
              shadows=shadows)


if __name__ == "__main__":
    main()
