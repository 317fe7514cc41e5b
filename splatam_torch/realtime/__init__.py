from splatam_torch.realtime.driver import FrameSource, ReplaySource, realtime_slam
from splatam_torch.realtime.handler import (
    ActiveViewHandler,
    GainConfig,
    associate_timestamps,
    pose_matrix_from_quaternion,
    relative_transformation,
)

__all__ = [
    "ActiveViewHandler",
    "GainConfig",
    "FrameSource",
    "ReplaySource",
    "realtime_slam",
    "associate_timestamps",
    "pose_matrix_from_quaternion",
    "relative_transformation",
]
