"""Batched TRS transform math (port of bevy_tpu/math/affine.py).

A batch of transforms is a `TRS` dict of three columns: translation
(..., 3), rotation quat (..., 4), scale (..., 3).
"""

import torch

from bevy_tpu_torch.math.quat import (
    quat_conjugate, quat_from_mat3, quat_identity, quat_mul,
    quat_rotate_vec3, quat_to_mat3,
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


def trs(translation=None, rotation=None, scale=None, shape=(),
        device="cpu"):
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    shape = tuple(shape)
    return TRS(
        translation=f32(translation) if translation is not None
        else torch.zeros(shape + (3,), device=device),
        rotation=f32(rotation) if rotation is not None
        else quat_identity(shape, device),
        scale=f32(scale) if scale is not None
        else torch.ones(shape + (3,), device=device))


def trs_identity(shape=(), device="cpu"):
    return trs(shape=shape, device=device)


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


def trs_transform_point(t, p):
    return quat_rotate_vec3(t["rotation"], t["scale"] * p) + t["translation"]


def trs_transform_vector(t, v):
    return quat_rotate_vec3(t["rotation"], t["scale"] * v)


def trs_to_affine(t):
    """(...) TRS -> (..., 3, 4) affine matrices."""
    return trs_to_mat4(t)[..., :3, :]


def affine_mul(a, b):
    """(..., 3, 4) @ (..., 3, 4) affine composition."""
    ra, ta = a[..., :3], a[..., 3]
    rb, tb = b[..., :3], b[..., 3]
    r = torch.einsum("...ij,...jk->...ik", ra, rb)
    t = torch.einsum("...ij,...j->...i", ra, tb) + ta
    return torch.cat([r, t[..., None]], -1)


def affine_to_trs(m):
    """(..., 3, 4) -> TRS, assuming no shear (ref:
    GlobalTransform::to_scale_rotation_translation)."""
    r3 = m[..., :3]
    scale = torch.sqrt(torch.sum(r3 * r3, -2))
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return TRS(translation=m[..., 3],
               rotation=quat_from_mat3(r3 / safe[..., None, :]),
               scale=scale)


def mat4_mul(a, b):
    return torch.einsum("...ij,...jk->...ik", a, b)


def mat4_transform_point(m, p):
    """(..., 4, 4) x (..., 3) -> (..., 3) with the perspective divide."""
    ph = torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype,
                                  device=p.device)], -1)
    out = torch.einsum("...ij,...j->...i", m, ph)
    return out[..., :3] / out[..., 3:4]
