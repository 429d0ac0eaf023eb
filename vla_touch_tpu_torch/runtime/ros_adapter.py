"""ROS adapter: the edge between the control loop and robot middleware
(counterpart of ``vla_touch_tpu/runtime/ros_adapter.py``).

The reference's deployment scripts are monolithic ROS1 nodes (subscribers
for two cameras, the EEF pose, the gripper state and a GelSight force
Twist; a locked arm publisher).  Here ROS is only an adapter at the
boundary: the control loop (:mod:`runtime.control_loop`) consumes
``Observation`` objects and emits action vectors, and this module
translates to and from ROS topics where ``rospy`` is present.  Everything
here is import-gated, so the port runs (and is tested, through
:class:`runtime.control_loop.EpisodeReplay`) without a ROS install.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from vla_touch_tpu_torch.runtime.control_loop import Observation


@dataclasses.dataclass
class RosTopics:
    """Topic map (defaults from ``frank_inference_eef.py:579-639``)."""

    camera1: str = "/camera1/color/image_raw"
    camera2: str = "/camera2/color/image_raw"
    eef_pose: str = "/franka/ee_pose"
    gripper_state: str = "/gripper/state"
    gelsight_force: str = "/gelsight/force"
    arm_command: str = "/franka/ee_command"
    gripper_command: str = "/gripper/command"


class RosOperator:
    """Buffered subscribers + locked publisher (reference ``RosOperator``).

    Construct only when rospy is importable; the control loop itself never
    touches ROS types.
    """

    def __init__(self, topics: Optional[RosTopics] = None,
                 publish_rate_hz: float = 6.0):
        try:
            import rospy  # noqa: F401
            from cv_bridge import CvBridge  # noqa: F401
        except ImportError as e:  # pragma: no cover - no ROS in CI
            raise RuntimeError(
                "rospy/cv_bridge not available; use EpisodeReplay for "
                "offline runs or implement a custom adapter") from e
        import rospy
        from cv_bridge import CvBridge
        from geometry_msgs.msg import PoseStamped, Twist
        from sensor_msgs.msg import Image
        from std_msgs.msg import Float64, Float64MultiArray

        self.topics = topics or RosTopics()
        self.rate_hz = publish_rate_hz
        self.bridge = CvBridge()
        self._lock = threading.Lock()
        self._latest = {"camera1": None, "camera2": None, "pose": None,
                        "gripper": None, "force": None}

        def make_img_cb(key):
            def cb(msg):
                img = self.bridge.imgmsg_to_cv2(msg, "rgb8")
                with self._lock:
                    self._latest[key] = img
            return cb

        rospy.Subscriber(self.topics.camera1, Image, make_img_cb("camera1"),
                         queue_size=1)
        rospy.Subscriber(self.topics.camera2, Image, make_img_cb("camera2"),
                         queue_size=1)

        def pose_cb(msg):
            p, o = msg.pose.position, msg.pose.orientation
            with self._lock:
                self._latest["pose"] = np.array(
                    [p.x, p.y, p.z, o.x, o.y, o.z, o.w])

        rospy.Subscriber(self.topics.eef_pose, PoseStamped, pose_cb,
                         queue_size=1)

        def grip_cb(msg):
            with self._lock:
                self._latest["gripper"] = float(msg.data)

        rospy.Subscriber(self.topics.gripper_state, Float64, grip_cb,
                         queue_size=1)

        def force_cb(msg):
            with self._lock:
                self._latest["force"] = np.array(
                    [msg.linear.x, msg.linear.y, msg.linear.z])

        rospy.Subscriber(self.topics.gelsight_force, Twist, force_cb,
                         queue_size=1)

        self._arm_pub = rospy.Publisher(self.topics.arm_command,
                                        Float64MultiArray, queue_size=1)
        self._grip_pub = rospy.Publisher(self.topics.gripper_command,
                                         Float64, queue_size=1)

    def observation(self) -> Optional[Observation]:
        """Latest synchronized observation, or None until all topics seen."""
        from vla_touch_tpu_torch.utils.geometry import quaternion_to_ortho6d

        with self._lock:
            snap = dict(self._latest)
        if any(v is None for v in snap.values()):
            return None
        pose = snap["pose"]
        o6 = np.asarray(quaternion_to_ortho6d(pose[3:7][None]))[0]
        state = np.concatenate([pose[:3], o6, [snap["gripper"]]])
        return Observation(state=state,
                           images=[snap["camera1"], snap["camera2"], None],
                           force=snap["force"])

    def publish_action(self, action: np.ndarray) -> None:
        """Publish a 10-D EEF action: 9-D pose command + gripper."""
        from std_msgs.msg import Float64, Float64MultiArray

        msg = Float64MultiArray()
        msg.data = list(np.asarray(action[:9], np.float64))
        with self._lock:
            self._arm_pub.publish(msg)
            self._grip_pub.publish(Float64(float(action[-1])))


def interpolate_action(prev: np.ndarray, target: np.ndarray,
                       max_step: np.ndarray) -> np.ndarray:
    """Linear action interpolation clamped per-dim (the ALOHA loop's
    smoothing, ``agilex_inference.py:65-74,251-284``): move from prev toward
    target by at most ``max_step`` per dim."""
    delta = np.asarray(target, np.float64) - np.asarray(prev, np.float64)
    return np.asarray(prev) + np.clip(delta, -np.asarray(max_step),
                                      np.asarray(max_step))
