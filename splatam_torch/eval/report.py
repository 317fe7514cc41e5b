"""Online progress telemetry during tracking and mapping.

Counterpart of ``splatam_tpu/eval/report.py`` (`report_progress` /
`report_loss`, `utils/eval_helpers.py:80-276`): ATE of the partial
trajectory (tracking) and PSNR / depth error of the current render, printed
or handed to a logger the caller injects.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from splatam_torch.core.losses import render_for_loss
from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose
from splatam_torch.core.transforms import pose_to_w2c
from splatam_torch.eval.ate import evaluate_ate
from splatam_torch.eval.metrics import psnr
from splatam_torch.render.binning import RasterConfig


def partial_trajectory_ate(
    params: Dict, gt_w2c_list: List[np.ndarray], up_to: int, first_w2c: np.ndarray
) -> float:
    """ATE of frames [0, up_to] against the ground truth, skipping frames
    whose ground-truth pose is NaN (`eval_helpers.py:166-199`)."""
    est = [np.asarray(first_w2c)]
    gt = [np.asarray(gt_w2c_list[0])]
    for idx in range(1, up_to + 1):
        if np.isnan(gt_w2c_list[idx]).any():
            continue
        est.append(pose_to_w2c(*get_pose(params, idx)).cpu().numpy())
        gt.append(np.asarray(gt_w2c_list[idx]))
    return evaluate_ate(gt, est)


@torch.no_grad()
def report_progress(
    params: Dict,
    frame_im: torch.Tensor,
    frame_depth: torch.Tensor,
    cam,
    raster_cfg: RasterConfig,
    time_idx: int,
    sil_thres: float,
    *,
    tracking: bool = False,
    gt_w2c_list: Optional[List[np.ndarray]] = None,
    first_w2c: Optional[np.ndarray] = None,
    log_fn=None,
) -> Dict[str, float]:
    """Render the current frame at its estimated pose and report PSNR and
    depth error (and the partial ATE when tracking)."""
    rot_t, tran_t = get_pose(params, time_idx)
    gauss = {k: params[k] for k in GAUSSIAN_KEYS}
    out, _ = render_for_loss(gauss, rot_t, tran_t, cam, raster_cfg,
                             gaussians_grad=False, camera_grad=False)
    im = out.color[:3]
    depth = out.color[3:4]
    sil = out.color[4]
    valid = frame_depth > 0
    mask = valid & (sil > sil_thres)[None] if tracking else valid
    stats = {
        "psnr": float(psnr(im * mask, frame_im * mask)),
        "depth_l1": float(
            ((depth - frame_depth).abs() * mask).sum()
            / torch.clamp(mask.sum(), min=1)
        ),
    }
    if tracking and gt_w2c_list is not None and first_w2c is not None:
        stats["ate"] = partial_trajectory_ate(
            params, gt_w2c_list, time_idx, first_w2c
        )
    if log_fn is not None:
        log_fn(stats)
    return stats


def report_loss(losses: Dict, log_fn, step: int, tracking=False, mapping=False):
    """Per-iteration loss stream (`eval_helpers.py:80-106`)."""
    stage = "tracking" if tracking else ("mapping" if mapping else "frame_opt")
    log_fn(
        {
            f"{stage}/loss": float(losses["loss"]),
            f"{stage}/rgb_loss": float(losses["im"]),
            f"{stage}/depth_loss": float(losses["depth"]),
            f"{stage}/step": step,
        }
    )
