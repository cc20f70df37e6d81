"""glass_and_coat on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/glass_and_coat.py (reference: examples/3d/clearcoat.rs and
examples/3d/transmission.rs).

Four coloured backdrop cubes, a tinted glass panel
(specular_transmission 1, ior 1.5) and a clearcoated sphere: the opaque
groups through kernels B1 and B2, the glass through TransmissionPlugin
(render/transmission.py: raster_batched into a temporary G-buffer on B1
and B2, then the screen-space refraction in plain PyTorch).

    python examples/torch_glass_and_coat.py              # 1280x720
    python examples/torch_glass_and_coat.py --profile 10 # + spans
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid, uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.transmission import (  # noqa: E402
    TransmissionPlugin,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=64, device=device)
    plugin = Mesh3dPlugin()
    sphere = plugin.add_mesh(uv_sphere(0.7, sectors=24, stacks=12))
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    TransmissionPlugin(plugin))
    app.insert_resource(AmbientLight(brightness=0.25))
    for i, col in enumerate([(0.9, 0.2, 0.2), (0.2, 0.9, 0.2),
                             (0.2, 0.3, 0.9), (0.9, 0.8, 0.2)]):
        app.world.spawn(
            Mesh3d(mesh=cube),
            MeshMaterial(base_color=(*col, 1.0),
                         emissive=tuple(c * 0.3 for c in col)),
            *transform_bundle(translation=(i * 1.6 - 2.4, 0.0, -2.0),
                              scale=(1.2, 2.5, 0.3)))
    app.world.spawn(
        Mesh3d(mesh=cube),
        MeshMaterial(base_color=(0.9, 0.95, 1.0, 1.0),
                     specular_transmission=1.0, ior=1.5,
                     perceptual_roughness=0.05),
        *transform_bundle(translation=(-1.2, 0.0, 0.5),
                          scale=(2.2, 2.2, 0.08)))
    app.world.spawn(
        Mesh3d(mesh=sphere),
        MeshMaterial(base_color=(0.6, 0.05, 0.05, 1.0),
                     perceptual_roughness=0.7, clearcoat=1.0,
                     clearcoat_roughness=0.08),
        *transform_bundle(translation=(1.6, 0.0, 0.6)))
    app.world.spawn(DirectionalLight(illuminance=1.2),
                    *transform_bundle(rotation=(-0.3, 0.25, 0.05, 0.92)))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 0.3, 5)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "glass_and_coat @1280x720")


if __name__ == "__main__":
    main()
