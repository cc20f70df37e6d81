"""Batched math foundations (port of bevy_tpu.math): `(..., D)` float32
tensors, vectorized over leading batch dims."""

from bevy_tpu_torch.math.quat import (  # noqa: F401
    quat_conjugate, quat_dot, quat_from_axis_angle, quat_from_euler,
    quat_mul, quat_nlerp, quat_normalize, quat_rotate_vec3, quat_slerp,
    quat_to_mat3,
)
from bevy_tpu_torch.math.affine import (  # noqa: F401
    TRS, trs_compose, trs_inverse, trs_to_mat4,
)
