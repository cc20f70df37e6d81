"""anti_aliasing on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/anti_aliasing.py (reference: examples/3d/anti_aliasing.rs — FXAA,
SMAA, TAA, CAS and supersampling side by side).

The JAX example's turned cube under one of the anti-aliasing modes:
`fxaa`, `smaa`, `cas`, `taa` (per-object motion vectors from the mesh
pass, Mesh3dPlugin(motion_vectors=True), and the TAA history pass; the
cube drifts and turns so the vectors are not zero), `ssaa` (every pass on
a 2 x 2 grid, 2560x1440 for the 1280x720 output, box-resolved in
frame_image) or `off`.

    python examples/torch_anti_aliasing.py --mode taa
    python examples/torch_anti_aliasing.py --mode ssaa --profile 10
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from bevy_tpu_torch import App, Query, Res, Update, With  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import RenderPlugin, post  # noqa: E402
from bevy_tpu_torch.render.camera import Camera3d  # noqa: E402
from bevy_tpu_torch.render.mesh import cuboid  # noqa: E402
from bevy_tpu_torch.render.mesh3d import (  # noqa: E402
    AmbientLight, DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial,
)
from bevy_tpu_torch.time import Time, TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    Transform, TransformPlugin, transform_bundle,
)

MODES = ("fxaa", "smaa", "cas", "taa", "ssaa", "off")


def build_app(width=1280, height=720, mode="taa", device="cuda") -> App:
    app = App(capacity=8, device=device)
    plugin = Mesh3dPlugin(motion_vectors=(mode == "taa"))
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    plugins = [TimePlugin(), TransformPlugin(),
               RenderPlugin(width=width, height=height,
                            ssaa=2 if mode == "ssaa" else 1), plugin]
    extra = {"fxaa": post.FxaaPlugin, "smaa": post.SmaaPlugin,
             "cas": post.CasPlugin, "taa": post.TaaPlugin}.get(mode)
    if extra is not None:
        plugins.append(extra())
    app.add_plugins(*plugins)
    app.insert_resource(AmbientLight(brightness=0.3))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 1, 4)))
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.8, 0.7, 0.3, 1.0)),
                    *transform_bundle(rotation=(0.0, 0.31, 0.13, 0.94)))
    if mode == "taa":
        @system
        def sway(q=Query(Transform, With(Mesh3d)), time=Res(Time)):
            # a sway along x and a spin about y: per-object motion
            t = time.elapsed
            tr = q.transform.translation
            x = (0.4 * torch.sin(t * 2.0)).expand(tr.shape[0], 1)
            q.transform.translation = torch.cat([x, tr[:, 1:]], 1)
            half = t * 0.4
            zero = torch.zeros_like(half)
            q.transform.rotation = torch.stack(
                [zero, torch.sin(half), zero, torch.cos(half)]).expand_as(
                q.transform.rotation)

        app.add_systems(Update, sway)
    return app


def main():
    import argparse

    from torch_post_processing import twin_main

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--mode", choices=MODES, default="taa")
    mode = ap.parse_known_args()[0].mode
    twin_main(__doc__, build_app, f"anti_aliasing {mode} @1280x720",
              mode=mode)


if __name__ == "__main__":
    main()
