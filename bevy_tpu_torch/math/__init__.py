"""Batched math foundations (port of bevy_tpu.math): `(..., D)` float32
tensors, vectorized over leading batch dims."""

from bevy_tpu_torch.math.quat import (  # noqa: F401
    quat_conjugate, quat_dot, quat_from_axis_angle, quat_from_euler,
    quat_from_mat3, quat_from_rotation_z, quat_identity, quat_mul,
    quat_nlerp, quat_normalize, quat_rotate_vec3, quat_slerp, quat_to_mat3,
)
from bevy_tpu_torch.math.affine import (  # noqa: F401
    TRS, affine_mul, affine_to_trs, mat4_mul, mat4_transform_point, trs,
    trs_compose, trs_identity, trs_inverse, trs_to_affine, trs_to_mat4,
    trs_transform_point, trs_transform_vector,
)
