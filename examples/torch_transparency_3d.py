"""transparency_3d on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/transparency_3d.py (reference: examples/3d/transparency_3d.rs —
alpha-blended panes over opaque geometry).

Three panes of alpha 0.5 before an opaque backdrop: the backdrop through
the group route (kernels B1 and B2), the panes through the transparent
phase, weighted-blended OIT in plain PyTorch (mesh3d.raster_transparent:
windows evaluated against the opaque depth, summed, then blended over the
opaque colour).

    python examples/torch_transparency_3d.py              # 1280x720
    python examples/torch_transparency_3d.py --profile 10 # + spans
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin()
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.85, 0.85, 0.85, 1.0)),
                    *transform_bundle(translation=(0.0, 0.0, -2.0),
                                      scale=(8.0, 5.0, 0.3)))
    panes = [((1.0, 0.15, 0.15, 0.5), (-1.0, 0.0, 0.5)),
             ((0.15, 1.0, 0.15, 0.5), (0.0, 0.0, 1.5)),
             ((0.15, 0.15, 1.0, 0.5), (1.0, 0.0, 2.5))]
    for color, pos in panes:
        app.world.spawn(Mesh3d(mesh=cube), MeshMaterial(base_color=color),
                        *transform_bundle(translation=pos,
                                          scale=(2.0, 2.0, 0.08)))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 0.5, 7.0)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "transparency_3d 3 panes @1280x720")


if __name__ == "__main__":
    main()
