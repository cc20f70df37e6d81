"""shader_material on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/shader_material.py (reference: examples/shader/
shader_material.rs — a user-written fragment shader).

A sphere through the group route (kernels B1 and B2) with
`Mesh3dPlugin(material_fn=fresnel_glow)`: the user's shading function
runs at the visibility buffer's resolve, on resolve_shade's normal and
material planes (the Material trait's position).

    python examples/torch_shader_material.py              # 1280x720
    python examples/torch_shader_material.py --profile 10 # + spans
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from bevy_tpu_torch import App  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import uv_sphere  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def fresnel_glow(n, mat, ok, light_vec):
    """Rim-glow shader: an emissive fresnel rim over a Lambert base (the
    CustomMaterial of shader_material.rs)."""
    lam = torch.clamp(-(n[..., 0] * light_vec[0] + n[..., 1] * light_vec[1]
                        + n[..., 2] * light_vec[2]), min=0.0)
    # the camera looks down -z: the rim is where the normal turns away
    rim = (1.0 - torch.abs(n[..., 2])) ** 3
    glow = torch.tensor([0.1, 0.5, 1.0], device=n.device)
    rgb = mat[..., 0:3] * (0.15 + 0.85 * lam[..., None]) + \
        glow * rim[..., None]
    return torch.cat([rgb, mat[..., 3:4]], -1)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=8, device=device)
    plugin = Mesh3dPlugin(material_fn=fresnel_glow)
    sphere = plugin.add_mesh(uv_sphere(0.9, 32, 20))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin)
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 0, 3)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.3, 0.2, 0.0, 0.93)))
    app.world.spawn(Mesh3d(mesh=sphere),
                    MeshMaterial(base_color=(0.6, 0.2, 0.8, 1.0)),
                    *transform_bundle())
    return app


def main():
    from torch_post_processing import twin_main
    twin_main(__doc__, build_app, "shader_material @1280x720")


if __name__ == "__main__":
    main()
