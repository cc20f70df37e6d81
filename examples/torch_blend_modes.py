"""blend_modes on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/blend_modes.py (reference: examples/3d/blend_modes.rs —
opaque and alpha-blended spheres side by side).

Spheres of alpha 1.0 (the opaque phase, kernels B1 and B2), 0.6 and 0.25
(the transparent phase: weighted-blended OIT in plain PyTorch) over a
slab.

    python examples/torch_blend_modes.py              # 1280x720
    python examples/torch_blend_modes.py --profile 10 # + spans
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
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin()
    sphere = plugin.add_mesh(uv_sphere(0.6, 20, 14))
    slab = plugin.add_mesh(cuboid(6.0, 0.2, 4.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    app.insert_resource(AmbientLight(brightness=0.25))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 1.2, 4)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(Mesh3d(mesh=slab),
                    MeshMaterial(base_color=(0.5, 0.5, 0.55, 1.0)),
                    *transform_bundle(translation=(0.0, -0.8, 0.0)))
    for x, a in ((-1.5, 1.0), (0.0, 0.6), (1.5, 0.25)):
        app.world.spawn(Mesh3d(mesh=sphere),
                        MeshMaterial(base_color=(0.9, 0.35, 0.2, a)),
                        *transform_bundle(translation=(x, 0.0, 0.0)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "blend_modes 3 spheres @1280x720")


if __name__ == "__main__":
    main()
