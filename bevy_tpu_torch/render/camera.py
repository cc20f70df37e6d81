"""3D camera (port of bevy_tpu/render/camera.py; ref: bevy_camera —
Camera3d + PerspectiveProjection, reverse-z infinite far).

Screen convention: pixel (0,0) is top-left, y down.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.math.affine import TRS, trs_inverse, trs_to_mat4


def pick_camera(mask):
    """Index of the first alive row with the component, and whether one
    exists — both as device tensors (no host sync)."""
    return torch.argmax(mask.to(torch.uint8)), torch.any(mask)


@component
class Camera3d:
    """3D perspective camera (ref: Camera3d + PerspectiveProjection — fov
    default π/4, near 0.1). vp_min/vp_max: viewport rect as target-size
    fractions; cameras render in ascending `order`."""
    fov = field((), default=0.7853981634)   # π/4 vertical
    near = field((), default=0.1)
    order = field((), torch.int32, default=0)
    layers = field((), torch.int32, default=1)  # ref: RenderLayers bitmask
    vp_min = field((2,), default=(0.0, 0.0))
    vp_max = field((2,), default=(1.0, 1.0))


def perspective_infinite_reverse(fov, aspect, near):
    """(4,4) projection, reverse-z in [0,1], infinite far (ref: glam
    Mat4::perspective_infinite_reverse_rh)."""
    f = 1.0 / torch.tan(fov * 0.5)
    z = torch.zeros_like(f)
    return torch.stack([
        torch.stack([f / aspect, z, z, z]),
        torch.stack([z, f, z, z]),
        torch.stack([z, z, z, near]),
        torch.stack([z, z, -torch.ones_like(f), z]),
    ])


def view_matrix(cam_translation, cam_rotation, cam_scale):
    """World→view (4,4): inverse of the camera's global TRS."""
    return trs_to_mat4(trs_inverse(TRS(translation=cam_translation,
                                       rotation=cam_rotation,
                                       scale=cam_scale)))
