"""Wall seconds per whole SLAM frame of the untraced window (slam/pipeline.rgbd_slam; host clock after a sync at each frame boundary)."""
from benchmark.core import readers


def read(ctx):
    return readers.wall_s_per_frame(ctx, "slam")
