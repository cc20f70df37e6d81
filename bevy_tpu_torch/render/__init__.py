"""Render core (port of bevy_tpu.render): camera, meshes, the framebuffer
plugin and the instanced 3D mesh pass (render/mesh3d.py)."""

from bevy_tpu_torch.render.plugin import (  # noqa: F401
    ClearColor, RenderPlugin, RenderTarget, frame_image,
)
