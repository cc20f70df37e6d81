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


def quat_identity(shape=(), device="cpu"):
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def quat_normalize(q):
    return safe_normalize(q)


def quat_from_rotation_z(angle):
    angle = torch.as_tensor(angle, dtype=torch.float32)
    s, c = torch.sin(angle * 0.5), torch.cos(angle * 0.5)
    zeros = torch.zeros_like(s)
    return torch.stack([zeros, zeros, s, c], -1)


def quat_from_mat3(m):
    """(..., 3, 3) -> (..., 4): Shepperd's method, branch-free."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(a, b, c, d):
        return torch.stack([a, b, c, d], -1)

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s0 = root(1.0 + tr)
    q0 = cand((m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = cand(0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1)
    s2 = root(1.0 - m00 + m11 - m22)
    q2 = cand((m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2)
    s3 = root(1.0 - m00 - m11 + m22)
    q3 = cand((m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3)
    use0 = tr > 0.0
    use1 = ~use0 & (m00 > m11) & (m00 > m22)
    use2 = ~use0 & ~use1 & (m11 > m22)
    q = torch.where(use0[..., None], q0,
                    torch.where(use1[..., None], q1,
                                torch.where(use2[..., None], q2, q3)))
    return quat_normalize(q)


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
