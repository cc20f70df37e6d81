"""ssr_demo on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/ssr_demo.py (reference: examples/3d/ssr.rs).

The JAX example's glossy metallic floor reflecting a sphere, deferred
(G-buffer on kernels B1 and B2, shade on B3); SsrPlugin marches each
pixel's reflected ray 24 steps against the depth buffer
(render/ssr.py). `--contact` adds screen-space contact shadows
(render/contact_shadows.py).

    python examples/torch_ssr_demo.py --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.contact_shadows import (  # noqa: E402
    ContactShadowsPlugin,
)
from bevy_tpu_torch.render.deferred import (  # noqa: E402
    DeferredLightingPlugin,
)
from bevy_tpu_torch.render.mesh import cuboid, uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.render.ssr import SsrPlugin  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, contact=False, device="cuda") -> App:
    app = App(capacity=16, device=device)
    plugin = Mesh3dPlugin(deferred=True)
    floor = plugin.add_mesh(cuboid(8.0, 0.2, 6.0))
    sphere = plugin.add_mesh(uv_sphere(0.7, 20, 14))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    DeferredLightingPlugin(),
                    SsrPlugin(steps=24, stride=0.6, thickness=0.8),
                    *([ContactShadowsPlugin()] if contact else []))
    app.insert_resource(AmbientLight(brightness=0.25))
    app.world.spawn(Camera3d(),
                    *transform_bundle(translation=(0, 1.6, 5),
                                      rotation=(-0.13, 0.0, 0.0, 0.991)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.4, 0.2, 0.0, 0.9)))
    # the glossy metallic floor: the SSR surface
    app.world.spawn(Mesh3d(mesh=floor),
                    MeshMaterial(base_color=(0.35, 0.4, 0.45, 1.0),
                                 metallic=0.9, perceptual_roughness=0.15),
                    *transform_bundle(translation=(0.0, -0.6, 0.0)))
    app.world.spawn(Mesh3d(mesh=sphere),
                    MeshMaterial(base_color=(0.9, 0.4, 0.2, 1.0)),
                    *transform_bundle(translation=(0.0, 0.5, 0.0)))
    return app


def main():
    import argparse

    from torch_post_processing import twin_main

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--contact", action="store_true")
    contact = ap.parse_known_args()[0].contact
    twin_main(__doc__, build_app,
              f"ssr_demo{' + contact shadows' if contact else ''} "
              f"@1280x720", contact=contact)


if __name__ == "__main__":
    main()
