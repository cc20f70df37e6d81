"""post_processing on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/post_processing.py (reference: examples/3d/bloom.rs, ssao.rs,
depth_of_field.rs, post_processing.rs — the whole effect chain over one
scene).

The JAX example's scene (24 cubes, three of them emissive, a directional
light) through SSAO, bloom, depth of field, CAS, FXAA and ACES
tonemapping (render/post.py), the mesh pass on kernels B1 and B2.

    python examples/torch_post_processing.py              # 1280x720
    python examples/torch_post_processing.py --profile 10 # + spans
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
from bevy_tpu_torch.render.post import (  # noqa: E402
    BloomPlugin, CasPlugin, DepthOfFieldPlugin, FxaaPlugin, SsaoPlugin,
    TonemappingPlugin,
)
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def build_app(width=1280, height=720, device="cuda") -> App:
    app = App(capacity=64, device=device)
    plugin = Mesh3dPlugin()
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height), plugin,
                    SsaoPlugin(intensity=1.5),
                    BloomPlugin(threshold=0.8, intensity=0.35),
                    DepthOfFieldPlugin(focal_distance=6.0, focal_range=3.0),
                    CasPlugin(strength=0.5), FxaaPlugin(),
                    TonemappingPlugin())
    for i in range(24):
        x = (i % 6) - 2.5
        z = -(i // 6) * 3.0
        emissive = (2.0, 1.6, 0.4) if i % 7 == 0 else (0.0, 0.0, 0.0)
        app.world.spawn(
            Mesh3d(mesh=cube),
            MeshMaterial(base_color=(0.4 + 0.1 * (i % 5), 0.45, 0.6, 1.0),
                         emissive=emissive),
            *transform_bundle(translation=(x * 1.6, 0.0, z)))
    app.world.spawn(DirectionalLight(illuminance=1.2),
                    *transform_bundle(rotation=(-0.35, 0.25, 0.08, 0.9)))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 1.5, 6.0)))
    return app


def twin_main(doc, build_app, label, **build_kw):
    """The 3D screen-pass twins' command line: --frames timed frames (CUDA
    events) after 3 warm ones, the render_stats counters, and --profile
    FRAMES frames of torch.profiler by span (system:*, mesh:*, lights:*,
    gizmo:*) with the kernel launches a frame."""
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20,
                    help="frames timed with CUDA events")
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args, _ = ap.parse_known_args()
    return run_timed(build_app(**build_kw), label, frames=args.frames,
                     profile_frames=args.profile)


def main():
    twin_main(__doc__, build_app, "post_processing 24 cubes @1280x720")


if __name__ == "__main__":
    main()
