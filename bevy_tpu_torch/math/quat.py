"""Batched quaternion ops (port of bevy_tpu/math/quat.py).

Layout: `(..., 4)` float32 tensors as `[x, y, z, w]` (glam convention).
The functions the frames and animation reach are ported.
"""

import torch


def cross(a, b):
    """Broadcasting (..., 3) cross product, component order of jnp.cross."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def safe_normalize(v, eps=1e-12):
    """Normalize along the last axis, zeros for zero-length vectors (ref:
    glam `normalize_or_zero`)."""
    sq = torch.sum(v * v, -1, keepdim=True)
    inv = torch.where(sq > eps, torch.rsqrt(torch.clamp(sq, min=eps)),
                      torch.zeros_like(sq))
    return v * inv


def quat_normalize(q):
    return safe_normalize(q)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def quat_mul(a, b):
    """Hamilton product a*b (apply b's rotation, then a's)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_from_axis_angle(axis, angle):
    """axis: (..., 3) unit vectors; angle: (...) radians (a float32 tensor
    or a number)."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    half = angle * 0.5
    s, c = torch.sin(half), torch.cos(half)
    return torch.cat([axis * s[..., None], c[..., None]], -1)


def quat_from_euler(yaw, pitch, roll):
    """YXZ order (ref: glam EulerRot::YXZ). Arguments are float32 tensors
    of one shape (scalars allowed)."""
    sy, cy = torch.sin(yaw * 0.5), torch.cos(yaw * 0.5)
    sp, cp = torch.sin(pitch * 0.5), torch.cos(pitch * 0.5)
    sr, cr = torch.sin(roll * 0.5), torch.cos(roll * 0.5)
    # q = Ry(yaw) * Rx(pitch) * Rz(roll)
    return torch.stack([
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * cp * cr + sy * sp * sr,
    ], dim=-1)


def quat_rotate_vec3(q, v):
    """Rotate (..., 3) vectors by (..., 4) quaternions (broadcasting)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat3(q):
    """(..., 4) -> (..., 3, 3) rotation matrices (column convention R @ v)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    m = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_dot(a, b):
    return torch.sum(a * b, -1)


def quat_nlerp(a, b, t):
    """Normalized lerp with hemisphere correction: `b` flips where the dot
    product is below 0 (the reference's animation blend)."""
    d = quat_dot(a, b)
    b = torch.where(d[..., None] < 0.0, -b, b)
    return quat_normalize(a + (b - a) * t)


def quat_slerp(a, b, t):
    """Spherical lerp, nlerp weights where nearly parallel (ref: glam
    slerp DOT_THRESHOLD)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=a.device)
    d = quat_dot(a, b)
    b = torch.where(d[..., None] < 0.0, -b, b)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    near = d > 0.9995
    safe_sin = torch.where(near, torch.ones_like(theta), torch.sin(theta))
    wa = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    wb = torch.where(near, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(a * wa[..., None] + b * wb[..., None])
