"""First-frame initialization and point-cloud back-projection.

Counterpart of ``splatam_tpu/slam/initialize.py`` (`get_pointcloud` /
`initialize_first_timestep`, `scripts/splatam.py:73-217`). Back-projection
is host-side numpy, as in the JAX package; the "knn" scale rule searches
the cloud's neighbours on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_torch.core.params import initialize_params
from splatam_torch.device import resolve_device
from splatam_torch.render.camera import setup_camera
from splatam_torch.utils.neighbors import mean_squared_knn_distance


def get_pointcloud(
    color: np.ndarray,  # (3, H, W) in [0, 1]
    depth: np.ndarray,  # (1, H, W)
    intrinsics: np.ndarray,  # (3, 3)
    w2c: np.ndarray,  # (4, 4)
    mask: np.ndarray | None = None,  # (H*W,) bool
    compute_mean_sq_dist: bool = False,
    mean_sq_dist_method: str = "projective",
    device=None,
):
    """Back-project pixels to a world-frame point cloud (+ colors).

    With ``compute_mean_sq_dist``, also each point's squared scale:
    "projective", (z / f)^2, or "knn", the mean squared distance to its 3
    nearest neighbours in the (masked) cloud, searched on ``device``."""
    if compute_mean_sq_dist and mean_sq_dist_method not in ("projective", "knn"):
        raise ValueError(f"Unknown mean_sq_dist_method {mean_sq_dist_method}")
    h, w = color.shape[1], color.shape[2]
    cx, cy = intrinsics[0][2], intrinsics[1][2]
    fx, fy = intrinsics[0][0], intrinsics[1][1]

    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    xx = ((xg - cx) / fx).reshape(-1)
    yy = ((yg - cy) / fy).reshape(-1)
    z = depth[0].reshape(-1).astype(np.float32)

    pts_cam = np.stack([xx * z, yy * z, z], axis=-1)
    c2w = np.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = color.reshape(3, -1).T
    point_cld = np.concatenate([pts, cols], axis=-1).astype(np.float32)

    mean3_sq_dist = None
    if compute_mean_sq_dist and mean_sq_dist_method == "projective":
        mean3_sq_dist = ((z / ((fx + fy) / 2)) ** 2).astype(np.float32)
    if mask is not None:
        point_cld = point_cld[mask]
        if mean3_sq_dist is not None:
            mean3_sq_dist = mean3_sq_dist[mask]
    if compute_mean_sq_dist:
        if mean_sq_dist_method == "knn":
            mean3_sq_dist = mean_squared_knn_distance(
                torch.as_tensor(point_cld[:, :3], device=resolve_device(device))
            ).cpu().numpy()
        return point_cld, mean3_sq_dist
    return point_cld


def initialize_first_timestep(
    color: np.ndarray,  # (H, W, 3) in [0, 255]
    depth: np.ndarray,  # (H, W, 1)
    intrinsics: np.ndarray,  # (3, 3) or (4, 4)
    pose: np.ndarray,  # (4, 4) c2w
    num_frames: int,
    scene_radius_depth_ratio: float,
    gaussian_distribution: str = "isotropic",
    mean_sq_dist_method: str = "projective",
    device=None,
):
    """Initial map from frame 0. Returns (params, variables, intrinsics3x3,
    first_w2c, camera, scene_radius)."""
    color_chw = np.transpose(color, (2, 0, 1)).astype(np.float32) / 255.0
    depth_chw = np.transpose(depth, (2, 0, 1)).astype(np.float32)
    k = np.asarray(intrinsics, dtype=np.float64)[:3, :3]
    w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
    cam = setup_camera(color_chw.shape[2], color_chw.shape[1], k, w2c,
                       device=device)
    mask = depth_chw[0].reshape(-1) > 0
    pt_cld, mean3_sq_dist = get_pointcloud(
        color_chw, depth_chw, k, w2c, mask=mask, compute_mean_sq_dist=True,
        mean_sq_dist_method=mean_sq_dist_method, device=cam.device,
    )
    params, variables = initialize_params(
        pt_cld, num_frames, mean3_sq_dist, gaussian_distribution,
        device=cam.device,
    )
    scene_radius = float(depth_chw.max() / scene_radius_depth_ratio)
    return params, variables, k, w2c, cam, scene_radius
