"""RenderPlugin (port of bevy_tpu/render/plugin.py; ref: bevy_render
RenderPlugin lib.rs:132, phase sets lib.rs:158-212).

The framebuffer is a device-resident resource: color channel-planar
(4, H, W) linear f32, depth reverse-z (H, W) cleared to 0 with a GREATER
test. `frame_image()` is the one host readback point (the present /
screenshot position).
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.color import image_to_srgb_u8
from bevy_tpu_torch.ecs.component import field, resource
from bevy_tpu_torch.ecs.query import Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.texture import TextureAtlas


class RenderTarget:
    RESOURCE = "render_target"


@resource
class ClearColor:
    """ref: ClearColor resource; linear RGBA."""
    color = field(4, default=(0.098, 0.098, 0.133, 1.0))


# Render-schedule system sets (ref: RenderSystems, lib.rs:158-212)
CLEAR_SET = "render:clear"
QUEUE_SET = "render:queue"
PASS_SET = "render:pass"        # 3D geometry passes (forward or G-buffer)
SHADE_SET = "render:shade"      # deferred lighting resolve
OVERLAY_SET = "render:overlay"  # transparent 2D composition (sprites)
POST_SET = "render:post"        # tonemap / post-process, after the overlay


@system(name="clear_render_target")
def clear_render_target(target=ResMut(RenderTarget.RESOURCE),
                        clear=Res(ClearColor)):
    target.color = clear.color[:, None, None].expand(target.color.shape)
    target.depth = torch.zeros_like(target.depth)


class RenderPlugin(Plugin):
    """width/height are static: they size the framebuffer and raster grids.

    ssaa=N renders every pass on an N x N grid of subsamples a pixel
    (ref: Msaa; ordered-grid supersampling: the same arrays, a bigger
    grid, no kernel change) and box-resolves in `frame_image`. `width`
    and `height` are then the grid's, `out_width` / `out_height` the
    output's. 3D cameras keep their framing (the aspect is the same); 2D
    cameras should set Camera2d(scale=1/N)."""

    def __init__(self, width: int = 1280, height: int = 720, ssaa: int = 1):
        self.ssaa = int(ssaa)
        self.width = width * self.ssaa
        self.height = height * self.ssaa
        self.out_width = width
        self.out_height = height

    def build(self, app):
        h, w, dev = self.height, self.width, app.device
        app.init_resource(ClearColor())
        app.insert_resource(RenderTarget.RESOURCE, {
            "color": torch.zeros((4, h, w), dtype=torch.float32, device=dev),
            "depth": torch.zeros((h, w), dtype=torch.float32, device=dev),
            "size": torch.tensor([w, h], dtype=torch.float32, device=dev),
            "ssaa": torch.tensor(self.ssaa, dtype=torch.int32, device=dev),
        })
        if TextureAtlas.RESOURCE not in app.world.state["res"]:
            # a 1x1 white atlas until the app installs its own
            app.insert_resource(TextureAtlas.RESOURCE, {
                "data": torch.ones((1, 1, 4), dtype=torch.float32,
                                   device=dev)})
        sched = app.schedule(Render)
        sched.configure_set(CLEAR_SET)
        sched.configure_set(QUEUE_SET, after=CLEAR_SET)
        sched.configure_set(PASS_SET, after=[CLEAR_SET, QUEUE_SET])
        sched.configure_set(SHADE_SET, after=[CLEAR_SET, PASS_SET])
        sched.configure_set(OVERLAY_SET,
                            after=[CLEAR_SET, PASS_SET, SHADE_SET])
        sched.configure_set(POST_SET, after=[CLEAR_SET, OVERLAY_SET])
        app.add_systems(Render, clear_render_target, in_set=CLEAR_SET)


def add_render_stats(app, *keys):
    """Add int32 zero counters `keys` (where missing) to the render_stats
    resource, which the geometry and lighting plugins share."""
    zero = torch.zeros((), dtype=torch.int32, device=app.device)
    stats = dict(app.world.state["res"].get("render_stats", {}))
    for k in keys:
        stats.setdefault(k, zero)
    app.insert_resource("render_stats", stats)


def frame_image(app) -> np.ndarray:
    """Host readback of the framebuffer as sRGB u8 (H, W, 4); an SSAA
    grid is box-filtered to the output size first, in linear space."""
    fb = app.world.state["res"][RenderTarget.RESOURCE]["color"]
    s = next((p.ssaa for p in app._plugins if isinstance(p, RenderPlugin)),
             1)
    if s > 1:
        _, h, w = fb.shape
        fb = fb.reshape(4, h // s, s, w // s, s).mean((2, 4))
    return image_to_srgb_u8(fb.permute(1, 2, 0)).cpu().numpy()
