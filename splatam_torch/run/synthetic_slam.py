"""End-to-end SLAM on the synthetic scene (no dataset needed).

Counterpart of ``splatam_tpu/run/synthetic_slam.py``: runs the full
tracking + densification + mapping loop on a textured synthetic sequence
and prints ATE / PSNR / depth-L1 and timing as one JSON line. Runs on the
GPU unless ``--device cpu`` is given.

Usage: python -m splatam_torch.run.synthetic_slam [--frames 20]
       [--width 320] [--height 240] [--track_iters 20] [--map_iters 30]
       [--window 10] [--fixed_binning] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from splatam_torch.core.losses import calc_psnr, render_for_loss
from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose, num_gaussians
from splatam_torch.data.synthetic import SyntheticDataset
from splatam_torch.device import resolve_device
from splatam_torch.eval.ate import evaluate_ate, trajectory_from_params
from splatam_torch.render.binning import RasterConfig
from splatam_torch.slam.pipeline import as_frame, rgbd_slam


def build_config(args) -> dict:
    """The JAX CLI's config (capacities are ignored by the port)."""
    return {
        "scene_radius_depth_ratio": 3.0,
        "gaussian_distribution": "isotropic",
        "map_every": 1,
        "keyframe_every": 5,
        "mapping_window_size": args.window,
        "seed": 0,
        "data": {"num_frames": args.frames},
        "raster": {"chunk": 128},
        "tracking": {
            "num_iters": args.track_iters,
            "forward_prop": True,
            "use_gt_poses": False,
            "use_sil_for_loss": True,
            "sil_thres": 0.99,
            "ignore_outlier_depth_loss": False,
            "fixed_binning": args.fixed_binning,
            "loss_weights": {"im": 0.5, "depth": 1.0},
            "lrs": {"cam_unnorm_rots": 2e-3, "cam_trans": 4e-3},
        },
        "mapping": {
            "num_iters": args.map_iters,
            "add_new_gaussians": True,
            "sil_thres": 0.5,
            "use_sil_for_loss": False,
            "ignore_outlier_depth_loss": False,
            "loss_weights": {"im": 0.5, "depth": 1.0},
            "prune_gaussians": True,
            "pruning_dict": {
                "start_after": 0, "stop_after": 20, "prune_every": 20,
                "removal_opacity_threshold": 0.005,
                "final_removal_opacity_threshold": 0.005,
                "reset_opacities": False, "reset_opacities_every": 500,
                "remove_big_after": 0,
            },
            "lrs": {
                "means3D": 1e-4, "rgb_colors": 2.5e-3,
                "unnorm_rotations": 1e-3, "logit_opacities": 0.05,
                "log_scales": 1e-3, "cam_unnorm_rots": 0.0, "cam_trans": 0.0,
            },
        },
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--track_iters", type=int, default=20)
    p.add_argument("--map_iters", type=int, default=30)
    p.add_argument("--window", type=int, default=10,
                   help="mapping_window_size (Replica uses 24)")
    p.add_argument("--fixed_binning", action="store_true",
                   help="tracking bins once per frame, at its start pose")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


@torch.no_grad()
def evaluate(state, ds, frames: int, cfg: RasterConfig):
    """Per-frame PSNR and depth L1 (lists) over the first ``frames`` frames
    at the poses in ``state.params``, where the ground truth has depth."""
    gauss = {k: state.params[k] for k in GAUSSIAN_KEYS}
    dev = state.cam.device
    psnrs, depth_l1s = [], []
    for t in range(frames):
        color, depth, _, _ = ds[t]
        im_gt, d_gt = as_frame(color, depth, dev)
        rot, tran = get_pose(state.params, t)
        out, _ = render_for_loss(gauss, rot, tran, state.cam, cfg,
                                 gaussians_grad=False, camera_grad=False)
        valid = d_gt > 0
        psnrs.append(float(calc_psnr(out.color[:3] * valid, im_gt * valid)))
        depth_l1s.append(float(
            ((out.color[3:4] - d_gt).abs() * valid).sum()
            / torch.clamp(valid.sum(), min=1)
        ))
    return psnrs, depth_l1s


def run(args):
    """Returns (the printed result dict, the final SlamState)."""
    dev = resolve_device(args.device)
    ds = SyntheticDataset(num_frames=args.frames, width=args.width,
                          height=args.height, seed=0, device=dev)
    config = build_config(args)
    t0 = time.time()
    state = rgbd_slam(config, ds, progress=False, device=dev)
    wall = time.time() - t0
    gt, est = trajectory_from_params(state.params, state.first_w2c,
                                     state.gt_w2c_all)
    psnr, depth_l1 = evaluate(state, ds, args.frames,
                              RasterConfig(**config["raster"]))
    result = {
        "ate_m": round(evaluate_ate(gt, est), 5),
        "psnr": round(float(np.mean(psnr)), 2),
        "depth_l1_m": round(float(np.mean(depth_l1)), 5),
        "gaussians": num_gaussians(state.params),
        "frames": args.frames,
        "wall_s": round(wall, 1),
        "s_per_frame": round(wall / args.frames, 2),
    }
    return result, state


def main(argv=None):
    result, _ = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
