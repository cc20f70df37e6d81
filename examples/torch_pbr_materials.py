"""pbr_materials on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/pbr_materials.py (reference: examples/3d/pbr.rs — a metallic x
roughness sweep lit by a light and an environment map).

The JAX example's 5 x 5 grid of spheres (metallic down the rows,
roughness across), a directional and a point light, deferred: the
G-buffer pass on kernels B1 and B2, the shade on B3, then
EnvironmentLightPlugin's image-based light from a gradient environment
(render/environment.py) over the G-buffer.

    python examples/torch_pbr_materials.py --profile 10
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
    DeferredLightingPlugin, PointLight,
)
from bevy_tpu_torch.render.environment import (  # noqa: E402
    EnvironmentLightPlugin, gradient_environment,
)
from bevy_tpu_torch.render.mesh import uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)

GRID = 5


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=64, device=device)
    plugin = Mesh3dPlugin(deferred=True)
    sphere = plugin.add_mesh(uv_sphere(0.45, sectors=24, stacks=12))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    DeferredLightingPlugin(),
                    EnvironmentLightPlugin(gradient_environment(),
                                           intensity=0.6))
    for i in range(GRID):            # metallic sweep (rows)
        for j in range(GRID):        # roughness sweep (columns)
            app.world.spawn(
                Mesh3d(mesh=sphere),
                MeshMaterial(base_color=(0.7, 0.2, 0.2, 1.0),
                             metallic=i / (GRID - 1),
                             perceptual_roughness=max(j / (GRID - 1), 0.05)),
                *transform_bundle(translation=(j - GRID / 2 + 0.5,
                                               i - GRID / 2 + 0.5, 0.0)))
    app.world.spawn(DirectionalLight(illuminance=1.0),
                    *transform_bundle(rotation=(-0.3, 0.2, 0.05, 0.93)))
    app.world.spawn(PointLight(intensity=40.0, range=30.0),
                    *transform_bundle(translation=(3.0, 3.0, 4.0)))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 0, 7.5)))
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "pbr_materials 25 spheres @1280x720")


if __name__ == "__main__":
    main()
