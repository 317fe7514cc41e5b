"""ROS adapter for the realtime driver (import-gated: rospy optional).

Counterpart of ``splatam_tpu/realtime/ros_bridge.py``. Topic parity with
`scripts/ros_handler.py:137-154`:
  subscribes  /ifpp_camera/rgb/image_rect_color   (sensor_msgs/Image)
              /ifpp_camera/depth/depth_registered (sensor_msgs/Image)
              /odometry                           (nav_msgs/Odometry)
              /ifpp/trigger_signal, /ifpp/finished_signal, /ifpp/stop_gs (Bool)
              /ifpp/gs_poses                      (geometry_msgs/PoseArray)
  publishes   /ifpp/gs_gains (Float32MultiArray), /ifpp/ready_signal (Bool)

Timestamp association uses max_dt = 0.08 s (`ros_handler.py:362-370`).
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from splatam_torch.realtime.driver import FrameSource
from splatam_torch.realtime.handler import pose_matrix_from_quaternion

try:  # pragma: no cover - requires a ROS environment
    import rospy
    from geometry_msgs.msg import PoseArray
    from nav_msgs.msg import Odometry
    from sensor_msgs.msg import Image
    from std_msgs.msg import Bool, Float32MultiArray

    HAS_ROS = True
except ImportError:  # pragma: no cover
    HAS_ROS = False


class RosFrameSource(FrameSource):  # pragma: no cover - requires ROS runtime
    """Live frame stream + gain request/response over ROS topics."""

    MAX_DT = 0.08

    def __init__(self, intrinsics: np.ndarray, node_name: str = "splatam_torch"):
        if not HAS_ROS:
            raise ImportError(
                "rospy is not available — RosFrameSource needs a ROS runtime; "
                "use ReplaySource for offline replay."
            )
        self.intrinsics = np.asarray(intrinsics)
        self._lock = threading.Lock()
        self._rgb = collections.deque(maxlen=32)
        self._depth = collections.deque(maxlen=32)
        self._odom = collections.deque(maxlen=256)
        self._gs_poses = collections.deque(maxlen=4)
        self._triggered = False
        self._finished = False

        rospy.init_node(node_name, anonymous=True)
        rospy.Subscriber(
            "/ifpp_camera/rgb/image_rect_color", Image, self._rgb_cb, queue_size=1
        )
        rospy.Subscriber(
            "/ifpp_camera/depth/depth_registered", Image, self._depth_cb, queue_size=1
        )
        rospy.Subscriber("/odometry", Odometry, self._odom_cb, queue_size=1)
        rospy.Subscriber("/ifpp/trigger_signal", Bool, self._trigger_cb, queue_size=1)
        rospy.Subscriber("/ifpp/finished_signal", Bool, self._finish_cb, queue_size=1)
        rospy.Subscriber("/ifpp/stop_gs", Bool, self._finish_cb, queue_size=1)
        rospy.Subscriber("/ifpp/gs_poses", PoseArray, self._poses_cb, queue_size=1)
        self._gain_pub = rospy.Publisher(
            "/ifpp/gs_gains", Float32MultiArray, queue_size=1
        )
        self._ready_pub = rospy.Publisher("/ifpp/ready_signal", Bool, queue_size=1)
        self._ready_pub.publish(Bool(data=True))

    # -- callbacks -----------------------------------------------------------
    def _rgb_cb(self, msg):
        img = np.frombuffer(msg.data, np.uint8).reshape(msg.height, msg.width, -1)
        with self._lock:
            self._rgb.append((msg.header.stamp.to_sec(), img[..., :3].copy()))

    def _depth_cb(self, msg):
        depth = np.frombuffer(msg.data, np.float32).reshape(msg.height, msg.width)
        with self._lock:
            self._depth.append((msg.header.stamp.to_sec(), depth.copy()))

    def _odom_cb(self, msg):
        p = msg.pose.pose
        vec = np.array(
            [p.position.x, p.position.y, p.position.z,
             p.orientation.x, p.orientation.y, p.orientation.z, p.orientation.w]
        )
        with self._lock:
            self._odom.append((msg.header.stamp.to_sec(), vec))

    def _trigger_cb(self, msg):
        if msg.data:
            self._triggered = True

    def _finish_cb(self, msg):
        if msg.data:
            self._finished = True

    def _poses_cb(self, msg):
        vecs = [
            np.array(
                [p.position.x, p.position.y, p.position.z,
                 p.orientation.x, p.orientation.y, p.orientation.z,
                 p.orientation.w]
            )
            for p in msg.poses
        ]
        with self._lock:
            self._gs_poses.append(vecs)

    # -- FrameSource protocol --------------------------------------------------
    def finished(self) -> bool:
        return self._finished or rospy.is_shutdown()

    def next_frame(self, timeout: float = 0.01):
        if not self._triggered:
            return None
        with self._lock:
            if not (self._rgb and self._depth and self._odom):
                return None
            t_img, color = self._rgb[-1]
            t_dep = np.array([t for t, _ in self._depth])
            t_odo = np.array([t for t, _ in self._odom])
            j = int(np.argmin(np.abs(t_dep - t_img)))
            k = int(np.argmin(np.abs(t_odo - t_img)))
            if (
                abs(t_dep[j] - t_img) > self.MAX_DT
                or abs(t_odo[k] - t_img) > self.MAX_DT
            ):
                return None
            depth = self._depth[j][1]
            pose = pose_matrix_from_quaternion(self._odom[k][1])
        self._triggered = False
        k4 = np.eye(4)
        k4[:3, :3] = self.intrinsics[:3, :3]
        return color.astype(np.float32), depth[..., None], k4, pose

    def pending_gain_request(self) -> Optional[Sequence[np.ndarray]]:
        with self._lock:
            if not self._gs_poses:
                return None
            while len(self._gs_poses) > 1:  # keep only the latest request
                self._gs_poses.popleft()
            return self._gs_poses.popleft()

    def publish_gains(self, gains: List[Dict[str, float]]) -> None:
        msg = Float32MultiArray()
        msg.data = [g["gain"] for g in gains]
        self._gain_pub.publish(msg)
