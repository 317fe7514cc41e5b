"""Online SLAM on an iPhone (NeRFCapture) stream.

Counterpart of ``splatam_tpu/tools/iphone_demo.py`` (`scripts/iphone_demo.py`:
the reference subscribes to NeRFCapture frames over CycloneDDS and runs
SplaTAM online). ``realtime_slam`` (``splatam_torch/realtime``) does the
SLAM; this module gives it its frame sources: a live DDS source
(import-gated) and a replay of a capture directory (what
``tools/nerfcapture2dataset.py`` writes), so the demo runs end to end on a
recorded capture without a DDS network. Runs on the GPU unless
``--device cpu`` is given.

Usage:
  python -m splatam_torch.tools.iphone_demo --capture_dir out [--sequence seq]
      [--num_iters 10] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from splatam_torch.data.datasets import _FLIP_YZ, NeRFCaptureDataset
from splatam_torch.device import resolve_device
from splatam_torch.realtime import GainConfig, ReplaySource, realtime_slam
from splatam_torch.tools.nerfcapture2dataset import (
    _resize_nearest,
    decode_frame,
    make_reader,
)
from splatam_torch.utils.checkpoint import save_params


def demo_config(num_iters: int = 10) -> dict:
    """iPhone-demo knobs (`scripts/iphone_demo.py` config block)."""
    return {
        "scene_radius_depth_ratio": 3.0,
        "gaussian_distribution": "isotropic",
        "seed": 0,
        "keyframe_every": 5,
        "mapping_window_size": 32,
        "data": {"max_frames": 2048},
        "raster": {"max_instances": 2**19, "max_per_tile": 1024, "chunk": 128},
        "tracking": {
            "num_iters": num_iters, "forward_prop": True, "use_gt_poses": False,
            "use_sil_for_loss": True, "sil_thres": 0.99,
            "ignore_outlier_depth_loss": False,
            "loss_weights": {"im": 0.5, "depth": 1.0},
            "lrs": {"cam_unnorm_rots": 2e-3, "cam_trans": 4e-3},
        },
        "mapping": {
            "num_iters": num_iters, "add_new_gaussians": True, "sil_thres": 0.5,
            "use_sil_for_loss": False, "ignore_outlier_depth_loss": False,
            "loss_weights": {"im": 0.5, "depth": 1.0},
            "prune_gaussians": False, "pruning_dict": {},
            "lrs": {"means3D": 1e-4, "rgb_colors": 2.5e-3,
                    "unnorm_rotations": 1e-3, "logit_opacities": 0.05,
                    "log_scales": 1e-3, "cam_unnorm_rots": 0.0,
                    "cam_trans": 0.0},
        },
    }


class DDSFrameSource:
    """Live NeRFCapture stream as a realtime FrameSource.

    The online-loop analog of `scripts/iphone_demo.py:200-567`: each DDS
    sample is decoded (tools/nerfcapture2dataset.decode_frame), the ARKit
    pose is converted to the GradSLAM frame (P @ X_WV @ P.T with
    P = diag(1,-1,-1,1), `iphone_demo.py:140-210`) and made relative to the
    first frame; color/depth are resized to the working resolution with
    intrinsics scaled to match (`iphone_demo.py:218-232`). ``reader`` is
    anything with `read_next()` (the cyclonedds DataReader from
    nerfcapture2dataset.make_reader, or a mock in tests).
    """

    def __init__(self, reader, num_frames: int, height: int, width: int):
        self.reader = reader
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.count = 0
        self._first_pose_inv = None

    def finished(self) -> bool:
        return self.count >= self.num_frames

    def next_frame(self, timeout: float = 0.01):
        sample = self.reader.read_next()
        if not sample:
            return None
        rgb, depth, x_wv = decode_frame(sample)
        if depth is None:
            depth = np.zeros(rgb.shape[:2], np.float32)
        pose = _FLIP_YZ @ x_wv.astype(np.float64) @ _FLIP_YZ.T
        if self._first_pose_inv is None:
            self._first_pose_inv = np.linalg.inv(pose)
        pose = self._first_pose_inv @ pose

        h0, w0 = rgb.shape[:2]
        yi = (np.arange(self.height) * h0 // self.height).clip(0, h0 - 1)
        xi = (np.arange(self.width) * w0 // self.width).clip(0, w0 - 1)
        color = rgb[yi[:, None], xi[None, :]].astype(np.float32)
        depth = _resize_nearest(depth, self.width, self.height).astype(
            np.float32
        )[..., None]
        k = np.eye(4, dtype=np.float64)
        k[0, 0] = sample.fl_x * self.width / w0
        k[1, 1] = sample.fl_y * self.height / h0
        k[0, 2] = sample.cx * self.width / w0
        k[1, 2] = sample.cy * self.height / h0
        self.count += 1
        return color, depth, k, pose

    def pending_gain_request(self):
        return None

    def publish_gains(self, gains) -> None:
        pass


def run_live(num_frames: int, num_iters: int = 10, height: int = 360,
             width: int = 480, device=None):  # pragma: no cover - DDS
    """Online SLAM on a live NeRFCapture stream (`iphone_demo.py:200-567`)."""
    dev = resolve_device(device)
    source = DDSFrameSource(make_reader(), num_frames, height, width)
    return realtime_slam(demo_config(num_iters), source, GainConfig(),
                         device=dev)


def run_on_capture(capture_basedir: str, sequence: str, num_iters: int = 10,
                   height: int = 360, width: int = 480, device=None):
    """Replay a NeRFCapture directory through ``realtime_slam`` on
    ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    ds = NeRFCaptureDataset(
        capture_basedir, sequence, desired_height=height, desired_width=width
    )
    source = ReplaySource(ds)
    return realtime_slam(demo_config(num_iters), source, GainConfig(),
                         device=dev)


def main(argv=None):
    p = argparse.ArgumentParser(description="SplaTAM on an iPhone stream")
    p.add_argument("--capture_dir", default=None,
                   help="basedir containing <sequence>/transforms.json")
    p.add_argument("--live", action="store_true",
                   help="subscribe to a live NeRFCapture DDS stream instead")
    p.add_argument("--num_frames", type=int, default=200,
                   help="frames to consume in --live mode")
    p.add_argument("--sequence", default=".")
    p.add_argument("--num_iters", type=int, default=10)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--out", default=None, help="save params.npz here")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must exist)")
    args = p.parse_args(argv)
    if not args.live and args.capture_dir is None:
        p.error("one of --capture_dir or --live is required")
    if args.live:
        state, _ = run_live(
            args.num_frames, args.num_iters, args.height, args.width,
            args.device,
        )
    else:
        state, _ = run_on_capture(
            args.capture_dir, args.sequence, args.num_iters, args.height,
            args.width, args.device,
        )
    if args.out:
        save_params(state.params, state.variables, args.out)
        print(f"saved map to {args.out}/params.npz")
    return state


if __name__ == "__main__":
    main()
