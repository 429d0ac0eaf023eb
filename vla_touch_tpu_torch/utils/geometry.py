"""Rotation conversions: quaternion / euler / matrix / 6-D code
(counterpart of ``vla_touch_tpu/utils/geometry.py``), in numpy.

Quaternions are scipy's ``xyzw``; euler angles are intrinsic ``xyz``
(roll-pitch-yaw, ``Rotation.from_quat(q).as_euler('xyz')``); the 6-D code is
the first two columns of the rotation matrix, flattened column-major.  The
arithmetic is float32, as the JAX package computes it (64-bit floats
disabled): inputs are cast to float32 first.  Every function works on the
last axis (or two) and broadcasts over leading dimensions.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def _f32(a) -> np.ndarray:
    return np.asarray(a, _F)


def normalize_vector(v, eps: float = 1e-8):
    """L2-normalise along the last axis with a magnitude floor.  The squares
    are summed as XLA:CPU reduces them: a float32 accumulator taking one
    fused multiply-add per element, in order (a product of two float32
    values is exact in float64)."""
    v = _f32(v)
    acc = np.zeros(v.shape[:-1], _F)
    for i in range(v.shape[-1]):
        x = v[..., i].astype(np.float64)
        acc = (x * x + acc).astype(_F)
    return v / np.maximum(np.sqrt(acc)[..., None], _F(eps))


def quaternion_to_rotation_matrix(quat):
    """Quaternion (..., 4) xyzw -> rotation matrix (..., 3, 3)."""
    q = normalize_vector(quat)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = _F(1), _F(2)
    m = np.stack([one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
                  two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
                  two * (xz - wy), two * (yz + wx), one - two * (xx + yy)], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotation_matrix_to_quaternion(m):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) xyzw, w >= 0.

    Shepperd's construction without branches: the four candidate
    quaternions, each scaled by its pivot, and the one of the largest pivot
    (the first on a tie) kept."""
    m = _f32(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    one = _F(1)
    tr = m00 + m11 + m22
    px = one + m00 - m11 - m22
    py = one - m00 + m11 - m22
    pz = one - m00 - m11 + m22
    pw = one + tr
    qx = np.stack([px, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    qy = np.stack([m01 + m10, py, m12 + m21, m02 - m20], axis=-1)
    qz = np.stack([m02 + m20, m12 + m21, pz, m10 - m01], axis=-1)
    qw = np.stack([m21 - m12, m02 - m20, m10 - m01, pw], axis=-1)
    best = np.argmax(np.stack([px, py, pz, pw], axis=-1), axis=-1)
    cands = np.stack([qx, qy, qz, qw], axis=-2)        # (..., candidate, xyzw)
    q = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = normalize_vector(q)
    return q * np.where(q[..., 3:4] < 0, _F(-1), _F(1))


def euler_to_rotation_matrix(euler):
    """Intrinsic-xyz euler (..., 3) -> rotation matrix (..., 3, 3):
    Rz(yaw) @ Ry(pitch) @ Rx(roll), as ``Rotation.from_euler('xyz', e)``."""
    e = _f32(euler)
    cx, sx = np.cos(e[..., 0]), np.sin(e[..., 0])
    cy, sy = np.cos(e[..., 1]), np.sin(e[..., 1])
    cz, sz = np.cos(e[..., 2]), np.sin(e[..., 2])
    m = np.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
                  cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
                  -sy, sx * cy, cx * cy], axis=-1)
    return m.reshape(e.shape[:-1] + (3, 3))


def rotation_matrix_to_euler(m):
    """Rotation matrix (..., 3, 3) -> intrinsic-xyz euler (..., 3).  At
    gimbal lock (|cos pitch| <= 1e-7) roll is 0 and yaw takes the whole
    rotation, as scipy does."""
    m = _f32(m)
    sy = np.clip(-m[..., 2, 0], _F(-1), _F(1))
    pitch = np.arcsin(sy)
    cos_pitch = np.sqrt(np.maximum(_F(1) - sy * sy, _F(0)))
    safe = cos_pitch > _F(1e-7)
    roll = np.where(safe, np.arctan2(m[..., 2, 1], m[..., 2, 2]), _F(0))
    yaw = np.where(safe, np.arctan2(m[..., 1, 0], m[..., 0, 0]),
                   np.arctan2(-m[..., 0, 1], m[..., 1, 1]))
    return np.stack([roll, pitch, yaw], axis=-1).astype(_F)


def quaternion_to_euler(quat):
    """Quaternion (..., 4) xyzw -> intrinsic-xyz euler (..., 3)."""
    return rotation_matrix_to_euler(quaternion_to_rotation_matrix(quat))


def euler_to_quaternion(euler):
    """Intrinsic-xyz euler (..., 3) -> quaternion (..., 4) xyzw, w >= 0."""
    return rotation_matrix_to_quaternion(euler_to_rotation_matrix(euler))


def rotation_matrix_to_ortho6d(m):
    """Rotation matrix (..., 3, 3) -> 6-D code (..., 6): the first two
    columns, column-major."""
    m = np.asarray(m)
    return np.swapaxes(m[..., :, :2], -1, -2).reshape(m.shape[:-2] + (6,))


def ortho6d_to_rotation_matrix(ortho6d):
    """6-D code (..., 6) -> rotation matrix (..., 3, 3) by Gram-Schmidt: the
    columns x, y, z."""
    o = _f32(ortho6d)
    x = normalize_vector(o[..., 0:3])
    z = normalize_vector(np.cross(x, o[..., 3:6]))
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def quaternion_to_ortho6d(quat):
    """Quaternion (..., 4) xyzw -> 6-D code (..., 6)."""
    return rotation_matrix_to_ortho6d(quaternion_to_rotation_matrix(quat))


def ortho6d_to_quaternion(ortho6d):
    """6-D code (..., 6) -> quaternion (..., 4) xyzw, w >= 0."""
    return rotation_matrix_to_quaternion(ortho6d_to_rotation_matrix(ortho6d))


def ee_pose_7d_to_9d(pose7):
    """[x, y, z, qx, qy, qz, qw] (..., 7) -> [x, y, z, ortho6d] (..., 9)."""
    p = _f32(pose7)
    return np.concatenate([p[..., :3], quaternion_to_ortho6d(p[..., 3:7])], axis=-1)


def ee_pose_9d_to_7d(pose9):
    """[x, y, z, ortho6d] (..., 9) -> [x, y, z, qx, qy, qz, qw] (..., 7)."""
    p = _f32(pose9)
    return np.concatenate([p[..., :3], ortho6d_to_quaternion(p[..., 3:9])], axis=-1)
