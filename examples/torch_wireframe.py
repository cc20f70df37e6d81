"""wireframe on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/wireframe.py (reference: examples/3d/wireframe.rs).

The JAX example's wireframed cube beside a plain sphere: the mesh pass on
kernels B1 and B2, and WireframePlugin's edges (render/wireframe.py)
drawn by the gizmo pass through the tile raster, kernel B4.

    python examples/torch_wireframe.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.gizmos import GizmosPlugin  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid, uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.wireframe import (  # noqa: E402
    Wireframe, WireframePlugin,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin()
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    sphere = plugin.add_mesh(uv_sphere(0.7, 16, 12))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    GizmosPlugin(capacity=4096),
                    WireframePlugin(mesh_plugin=plugin))
    app.insert_resource(AmbientLight(brightness=0.3))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 1, 4)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.4, 0.5, 0.8, 1.0)),
                    Wireframe(),
                    *transform_bundle(translation=(-1.0, 0.0, 0.0),
                                      rotation=(0.0, 0.26, 0.0, 0.966)))
    app.world.spawn(Mesh3d(mesh=sphere),
                    MeshMaterial(base_color=(0.8, 0.5, 0.3, 1.0)),
                    *transform_bundle(translation=(1.0, 0.0, 0.0)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "wireframe @1280x720")


if __name__ == "__main__":
    main()
