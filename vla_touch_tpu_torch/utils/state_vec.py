"""Unified 128-dim state/action vector layout.

The port's own copy of ``vla_touch_tpu/utils/state_vec.py`` (pure numpy):
a 128-slot unified vector in which each physically meaningful quantity has
a fixed index, so heterogeneous robots share one action space.

Layout (right side mirrors the upstream RDT-1B convention):

====================  ===========
slots                 contents
====================  ===========
[0, 10)               right arm joint positions
[10, 15)              right gripper joint positions (10 = gripper_open)
[15, 25)              right arm joint velocities
[25, 30)              right gripper joint velocities
[30, 33)              right EEF position x/y/z
[33, 39)              right EEF 6D rotation (ortho6d)
[39, 42)              right EEF linear velocity
[42, 45)              right EEF angular velocity
[45, 50)              reserved
[50, 60)              left arm joint positions
[60, 65)              left gripper joint positions (60 = left_gripper_open)
[65, 75)              left arm joint velocities
[75, 80)              left gripper joint velocities
[80, 83)              left EEF position
[83, 89)              left EEF 6D rotation
[89, 92)              left EEF linear velocity
[92, 95)              left EEF angular velocity
[95, 100)             reserved
[100, 102)            base linear velocity
[102, 103)            base angular velocity
[103, 128)            reserved
====================  ===========
"""

from __future__ import annotations

import numpy as np

STATE_VEC_LEN = 128


def _build_mapping() -> dict:
    m: dict[str, int] = {}
    # Right arm (also the unprefixed default, matching upstream convention).
    for i in range(10):
        m[f"arm_joint_{i}_pos"] = i
        m[f"right_arm_joint_{i}_pos"] = i
    for i in range(5):
        m[f"gripper_joint_{i}_pos"] = 10 + i
        m[f"right_gripper_joint_{i}_pos"] = 10 + i
    m["gripper_open"] = 10
    m["right_gripper_open"] = 10
    for i in range(10):
        m[f"arm_joint_{i}_vel"] = 15 + i
        m[f"right_arm_joint_{i}_vel"] = 15 + i
    for i in range(5):
        m[f"gripper_joint_{i}_vel"] = 25 + i
        m[f"right_gripper_joint_{i}_vel"] = 25 + i
    m["gripper_open_vel"] = 25
    m["right_gripper_open_vel"] = 25
    for ax, off in (("x", 0), ("y", 1), ("z", 2)):
        m[f"eef_pos_{ax}"] = 30 + off
        m[f"right_eef_pos_{ax}"] = 30 + off
    for i in range(6):
        m[f"eef_angle_{i}"] = 33 + i
        m[f"right_eef_angle_{i}"] = 33 + i
    for ax, off in (("x", 0), ("y", 1), ("z", 2)):
        m[f"eef_vel_{ax}"] = 39 + off
        m[f"right_eef_vel_{ax}"] = 39 + off
    for ax, off in (("roll", 0), ("pitch", 1), ("yaw", 2)):
        m[f"eef_angular_vel_{ax}"] = 42 + off
        m[f"right_eef_angular_vel_{ax}"] = 42 + off
    # Left arm.
    for i in range(10):
        m[f"left_arm_joint_{i}_pos"] = 50 + i
    for i in range(5):
        m[f"left_gripper_joint_{i}_pos"] = 60 + i
    m["left_gripper_open"] = 60
    for i in range(10):
        m[f"left_arm_joint_{i}_vel"] = 65 + i
    for i in range(5):
        m[f"left_gripper_joint_{i}_vel"] = 75 + i
    m["left_gripper_open_vel"] = 75
    for ax, off in (("x", 0), ("y", 1), ("z", 2)):
        m[f"left_eef_pos_{ax}"] = 80 + off
    for i in range(6):
        m[f"left_eef_angle_{i}"] = 83 + i
    for ax, off in (("x", 0), ("y", 1), ("z", 2)):
        m[f"left_eef_vel_{ax}"] = 89 + off
    for ax, off in (("roll", 0), ("pitch", 1), ("yaw", 2)):
        m[f"left_eef_angular_vel_{ax}"] = 92 + off
    # Mobile base.
    m["base_vel_x"] = 100
    m["base_vel_y"] = 101
    m["base_angular_vel"] = 102
    return m


STATE_VEC_IDX_MAPPING = _build_mapping()

# 10-D Franka EEF layout used throughout the manipulation stack:
# [pos_x, pos_y, pos_z, ortho6d_0..5, gripper_open]
FRANKA_EEF_STATE_INDICES = (
    [STATE_VEC_IDX_MAPPING["eef_pos_x"],
     STATE_VEC_IDX_MAPPING["eef_pos_y"],
     STATE_VEC_IDX_MAPPING["eef_pos_z"]]
    + [STATE_VEC_IDX_MAPPING[f"eef_angle_{i}"] for i in range(6)]
    + [STATE_VEC_IDX_MAPPING["right_gripper_open"]]
)

# 8-D Franka joint layout: 7 joints + gripper
FRANKA_JOINT_STATE_INDICES = (
    [STATE_VEC_IDX_MAPPING[f"arm_joint_{i}_pos"] for i in range(7)]
    + [STATE_VEC_IDX_MAPPING["right_gripper_open"]]
)

# 14-D ALOHA/agilex bimanual joint layout
ALOHA_STATE_INDICES = (
    [STATE_VEC_IDX_MAPPING[f"left_arm_joint_{i}_pos"] for i in range(6)]
    + [STATE_VEC_IDX_MAPPING["left_gripper_open"]]
    + [STATE_VEC_IDX_MAPPING[f"right_arm_joint_{i}_pos"] for i in range(6)]
    + [STATE_VEC_IDX_MAPPING["right_gripper_open"]]
)


def fill_in_state(values: np.ndarray, indices=FRANKA_EEF_STATE_INDICES,
                  state_dim: int = STATE_VEC_LEN) -> np.ndarray:
    """Scatter a low-dim state/action vector into the 128-D unified vector.

    ``values`` has shape (..., len(indices)); returns (..., state_dim) with
    all other slots zero (reference semantics:
    ``unified_vla_dataset_episode.py:480-495``).
    """
    values = np.asarray(values)
    uni = np.zeros(values.shape[:-1] + (state_dim,), dtype=values.dtype)
    uni[..., list(indices)] = values
    return uni


def extract_state(uni_vec: np.ndarray, indices=FRANKA_EEF_STATE_INDICES) -> np.ndarray:
    """Gather the low-dim vector back out of the unified 128-D vector."""
    return np.asarray(uni_vec)[..., list(indices)]
