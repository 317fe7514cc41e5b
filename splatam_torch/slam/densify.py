"""Silhouette/depth-error-driven densification.

Counterpart of ``splatam_tpu/slam/densify.py`` (`add_new_gaussians`,
`scripts/splatam.py:384-426`): render depth and silhouette at the frame's
pose, back-project the pixels the map fails to explain, and append them.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_torch.core.losses import median, render_for_loss
from splatam_torch.core.params import (
    GAUSSIAN_KEYS,
    Params,
    Variables,
    append_gaussians,
    gaussian_values,
)
from splatam_torch.core.transforms import pose_to_w2c
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import Camera
from splatam_torch.slam.initialize import get_pointcloud


@torch.no_grad()
def add_new_gaussians(
    params: Params,
    variables: Variables,
    frame_im: torch.Tensor,  # (3, H, W)
    frame_depth: torch.Tensor,  # (1, H, W)
    intrinsics: np.ndarray,  # (3, 3)
    cam: Camera,
    cfg: RasterConfig,
    sil_thres: float,
    time_idx: int,
    gaussian_distribution: str,
    pose,  # (rot (4,), tran (3,))
):
    """Returns (params, variables, num_added)."""
    cam_rot, cam_tran = pose
    gauss = {k: params[k] for k in GAUSSIAN_KEYS}
    out, _ = render_for_loss(
        gauss, cam_rot, cam_tran, cam, cfg, gaussians_grad=False,
        camera_grad=False,
    )
    render_depth, silhouette = out.color[3], out.color[4]
    gt_depth = frame_depth[0]
    depth_error = (gt_depth - render_depth).abs() * (gt_depth > 0)
    non_presence = (silhouette < sil_thres) | (
        (render_depth > gt_depth) & (depth_error > 50 * median(depth_error))
    )
    mask = (non_presence & (gt_depth > 0)).reshape(-1).cpu().numpy()
    if not mask.any():
        return params, variables, 0
    curr_w2c = pose_to_w2c(cam_rot, cam_tran).cpu().numpy()
    pt_cld, mean3_sq_dist = get_pointcloud(
        frame_im.cpu().numpy(), frame_depth.cpu().numpy(), intrinsics,
        curr_w2c, mask=mask, compute_mean_sq_dist=True,
    )
    params, variables = append_gaussians(
        params, variables,
        gaussian_values(pt_cld, mean3_sq_dist, gaussian_distribution),
        time_idx,
    )
    return params, variables, int(pt_cld.shape[0])
