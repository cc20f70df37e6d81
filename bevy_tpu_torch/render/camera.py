"""Cameras (port of bevy_tpu/render/camera.py; ref: bevy_camera —
Camera3d + PerspectiveProjection, reverse-z infinite far; Camera2d +
OrthographicProjection, 1 world unit = 1 pixel at scale 1, origin
centred, +y up).

Screen convention: pixel (0,0) is top-left, y down; the 2D world→screen
transform flips y exactly once.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.math.affine import TRS, trs_inverse, trs_to_mat4


@lru_cache(maxsize=None)
def consts(device):
    """Constant vectors on `device`, made once (no per-frame copies): the
    unit axes x, y and -z (a light's forward) and unit scale."""
    ax = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0],
                       [1.0, 1.0, 1.0]], device=device)
    return {"x": ax[0], "y": ax[1], "-z": ax[2], "ones": ax[3]}


def pick_camera(mask):
    """Index of the first alive row with the component, and whether one
    exists — both as device tensors (no host sync)."""
    return torch.argmax(mask.to(torch.uint8)), torch.any(mask)


def camera_row(column, idx):
    """Row `idx` (a 0-d index tensor, from pick_camera / select_cameras)
    of a camera column, gathered on the device: indexing with a 0-d
    tensor would read it back to the host, a sync a pick."""
    return column.index_select(0, idx.reshape(1))[0]


def select_cameras(order, mask, k: int):
    """First k alive cameras in ascending `order`, ties broken by row
    (ref: ascending Camera::order drives the render-pass sequence): the
    int32 key order * n + row, a stable argsort. Returns (ids (k,) int32,
    valid (k,) bool)."""
    n = order.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=order.device)
    key = torch.where(mask, order * n + rows,
                      torch.full_like(rows, 2 ** 31 - 1))
    ids = torch.argsort(key, stable=True)[:k]
    return ids.to(torch.int32), mask[ids]


@component
class Camera2d:
    """2D orthographic camera (ref: Camera2d + OrthographicProjection with
    ScalingMode::WindowSize). `scale` = world units per pixel; `order`
    breaks ties between cameras (ref: Camera::order). vp_min/vp_max: the
    viewport rect as target-size fractions (ref: Camera::viewport — 2D
    split-screen); the sprite pass reads them when built with
    max_cameras > 1."""
    scale = field((), default=1.0)
    order = field((), torch.int32, default=0)
    layers = field((), torch.int32, default=1)  # ref: RenderLayers bitmask
    vp_min = field((2,), default=(0.0, 0.0))
    vp_max = field((2,), default=(1.0, 1.0))


class OrthographicProjection:
    """Host-side helper mirroring the reference's projection struct."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale


def world_to_screen_2d(xy, cam_xy, cam_cos, cam_sin, cam_scale, width,
                       height):
    """World points (N, 2) -> pixel coords (N, 2), y down: the inverse
    camera rotation, the projection scale, recentred on the target (ref:
    the view uniform of bevy_render/src/view/mod.rs, in closed 2D form)."""
    d = xy - cam_xy
    vx = cam_cos * d[..., 0] + cam_sin * d[..., 1]
    vy = -cam_sin * d[..., 0] + cam_cos * d[..., 1]
    return torch.stack([width * 0.5 + vx / cam_scale,
                        height * 0.5 - vy / cam_scale], -1)


def quat_z_angle(q):
    """Rotation angle about +z of (..., 4) xyzw quaternions (the 2D paths
    rotate about z only, as the reference's do)."""
    return 2.0 * torch.atan2(q[..., 2], q[..., 3])


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


def pixel_world(inv_vp, depth, width, height):
    """World positions (H, W, 3) of the pixel centres at reverse-z `depth`
    (H, W) under the inverse view projection `inv_vp` (4,4)."""
    dev = depth.device
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    ndc = torch.stack([(2.0 * xs / width - 1.0).expand(depth.shape),
                       (1.0 - 2.0 * ys / height).expand(depth.shape), depth,
                       torch.ones_like(depth)], -1)
    wh = torch.einsum("ij,hwj->hwi", inv_vp, ndc)
    ww = wh[..., 3:4]
    return wh[..., :3] / torch.where(torch.abs(ww) > 1e-9, ww,
                                     torch.ones_like(ww))
