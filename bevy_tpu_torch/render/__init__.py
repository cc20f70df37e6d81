"""Render core (port of bevy_tpu.render): cameras, meshes, the framebuffer
plugin, the instanced 3D mesh pass (render/mesh3d.py), deferred lighting
(render/deferred.py), the 2D sprite pass (render/sprite.py) over the
texture atlas (render/texture.py), and the 3D screen passes
(render/post.py, skybox.py, fog.py, atmosphere.py, environment.py,
irradiance.py, ssr.py, contact_shadows.py, decal.py, wireframe.py)."""

from bevy_tpu_torch.render.camera import (  # noqa: F401
    Camera2d, OrthographicProjection,
)
from bevy_tpu_torch.render.plugin import (  # noqa: F401
    ClearColor, RenderPlugin, RenderTarget, frame_image,
)
from bevy_tpu_torch.render.sprite import (  # noqa: F401
    Anchor, Sprite, SpritePlugin, sprite_from_handle,
)
from bevy_tpu_torch.render.texture import (  # noqa: F401
    AtlasBuilder, TextureAtlas, checkerboard,
)
