"""Rotation conversions the episode reader needs (counterpart of part of
``vla_touch_tpu/utils/geometry.py``), in numpy.

Quaternions are scipy's ``xyzw``; the 6-D code is the first two columns of
the rotation matrix, flattened column-major.  The arithmetic is float32, as
the JAX package computes it (64-bit floats disabled).
"""

from __future__ import annotations

import numpy as np


def normalize_vector(v, eps: float = 1e-8):
    """L2-normalise along the last axis with a magnitude floor.  The squares
    are summed as XLA:CPU reduces them: a float32 accumulator taking one
    fused multiply-add per element, in order (a product of two float32
    values is exact in float64)."""
    v = np.asarray(v, np.float32)
    acc = np.zeros(v.shape[:-1], np.float32)
    for i in range(v.shape[-1]):
        x = v[..., i].astype(np.float64)
        acc = (x * x + acc).astype(np.float32)
    return v / np.maximum(np.sqrt(acc)[..., None], np.float32(eps))


def quaternion_to_rotation_matrix(quat):
    """Quaternion (..., 4) xyzw -> rotation matrix (..., 3, 3)."""
    q = normalize_vector(quat)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = np.float32(1), np.float32(2)
    m = np.stack([one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
                  two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
                  two * (xz - wy), two * (yz + wx), one - two * (xx + yy)], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotation_matrix_to_ortho6d(m):
    """Rotation matrix (..., 3, 3) -> 6-D code (..., 6): the first two
    columns, column-major."""
    m = np.asarray(m)
    return np.swapaxes(m[..., :, :2], -1, -2).reshape(m.shape[:-2] + (6,))


def quaternion_to_ortho6d(quat):
    """Quaternion (..., 4) xyzw -> 6-D code (..., 6)."""
    return rotation_matrix_to_ortho6d(quaternion_to_rotation_matrix(quat))
