"""3d_scene on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/3d_scene.py (reference: examples/3d/3d_scene.rs, with the
procedural sky of examples/3d/skybox.rs).

The JAX example's base and cube under a directional light, the
background filled by SkyboxPlugin's procedural sky with the light's sun
disc (render/skybox.py); `--atmosphere` draws the background with the
single-scattering AtmospherePlugin (render/atmosphere.py) instead.

    python examples/torch_3d_scene.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.atmosphere import AtmospherePlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.post import TonemappingPlugin  # noqa: E402
from bevy_tpu_torch.render.skybox import SkyboxPlugin  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, atmosphere=False,
              device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin()
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    sky = [AtmospherePlugin(), TonemappingPlugin()] if atmosphere else         [SkyboxPlugin()]
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin, *sky)
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.3, 0.5, 0.3, 1.0)),
                    *transform_bundle(translation=(0.0, -0.55, 0.0),
                                      scale=(8.0, 0.1, 8.0)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.6, 0.7, 0.8, 1.0)),
                    *transform_bundle(translation=(0.0, 0.5, 0.0)))
    app.world.spawn(DirectionalLight(illuminance=1.2),
                    *transform_bundle(rotation=(-0.35, 0.28, 0.1, 0.89)))
    app.world.spawn(Camera3d(), *transform_bundle(
        translation=(-2.5, 2.5, 6.0), rotation=(-0.15, -0.18, -0.03, 0.97)))
    return app


def main():
    import argparse

    from torch_post_processing import twin_main

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--atmosphere", action="store_true")
    atmo = ap.parse_known_args()[0].atmosphere
    twin_main(__doc__, build_app,
              f"3d_scene ({'atmosphere' if atmo else 'skybox'}) @1280x720",
              atmosphere=atmo)


if __name__ == "__main__":
    main()
