"""Batched TRS transform math (port of bevy_tpu/math/affine.py).

A batch of transforms is a `TRS` dict of three columns: translation
(..., 3), rotation quat (..., 4), scale (..., 3).
"""

import torch

from bevy_tpu_torch.math.quat import (
    quat_conjugate, quat_mul, quat_rotate_vec3, quat_to_mat3,
)


class TRS(dict):
    """Transform batch: keys translation/rotation/scale."""

    @property
    def translation(self):
        return self["translation"]

    @property
    def rotation(self):
        return self["rotation"]

    @property
    def scale(self):
        return self["scale"]


def trs_compose(parent, child):
    """parent * child (ref: GlobalTransform::mul_transform); component-wise
    scale composition, as the reference documents."""
    scale = parent["scale"] * child["scale"]
    rotation = quat_mul(parent["rotation"], child["rotation"])
    translation = parent["translation"] + quat_rotate_vec3(
        parent["rotation"], parent["scale"] * child["translation"])
    return TRS(translation=translation, rotation=rotation, scale=scale)


def trs_inverse(t):
    inv_rot = quat_conjugate(t["rotation"])
    inv_scale = 1.0 / t["scale"]
    inv_trans = quat_rotate_vec3(inv_rot, -t["translation"]) * inv_scale
    return TRS(translation=inv_trans, rotation=inv_rot, scale=inv_scale)


def trs_to_mat4(t):
    """(...) TRS -> (..., 4, 4) matrices (M @ [p; 1])."""
    rs = quat_to_mat3(t["rotation"]) * t["scale"][..., None, :]
    m = torch.zeros(rs.shape[:-2] + (4, 4), dtype=torch.float32,
                    device=rs.device)
    m[..., :3, :3] = rs
    m[..., :3, 3] = t["translation"]
    m[..., 3, 3] = 1.0
    return m
