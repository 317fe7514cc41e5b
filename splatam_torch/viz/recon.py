"""Reconstruction visualization from a saved params.npz.

Counterpart of ``splatam_tpu/viz/recon.py`` (`viz_scripts/final_recon.py`,
the interactive Open3D view, and `viz_scripts/online_recon.py`, the
per-keyframe replay). The headless path renders the estimated trajectory
with the port's rasterizer (``core/losses.render_for_loss``: B1 in the
aligned layout, B3a and B3b in the split one) and writes PNGs with
imageio, else Pillow (``data.base.imwrite``), and a trajectory plot with
matplotlib; the interactive Open3D views need open3d and a display.
The map is the live Gaussians of ``load_params``: no ``active`` mask.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from splatam_torch.core.losses import render_for_loss
from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose
from splatam_torch.core.transforms import matrix_to_quaternion
from splatam_torch.data.base import imwrite
from splatam_torch.device import resolve_device
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera
from splatam_torch.viz.geometry import (
    camera_frustum_lines,
    estimated_w2cs,
    frustum_colors,
    scene_geometry,
    trajectory_colors,
    trajectory_lineset,
)


def rgbd2pcd(
    color: np.ndarray,  # (3, H, W) [0..1]
    depth: np.ndarray,  # (1, H, W) meters
    w2c: np.ndarray,
    intrinsics: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Back-project a rendered RGB-D frame to a world-frame point cloud
    (`viz_scripts/final_recon.py` rgbd2pcd analog)."""
    _, h, w = color.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    z = depth[0]
    pts_cam = np.stack(
        [(xx - cx) / fx * z, (yy - cy) / fy * z, z, np.ones_like(z)], axis=-1
    ).reshape(-1, 4)
    pts_world = (np.linalg.inv(w2c) @ pts_cam.T).T[:, :3]
    cols = color.reshape(3, -1).T
    valid = z.reshape(-1) > 0
    return pts_world[valid], cols[valid]


def _gaussians(params: Dict, dev, keep: torch.Tensor | None = None):
    gauss = {k: torch.as_tensor(params[k]).to(dev) for k in GAUSSIAN_KEYS}
    if keep is not None:
        gauss = {k: v[keep.to(dev)] for k, v in gauss.items()}
    return gauss


def _trajectory(params: Dict, dev):
    return {k: torch.as_tensor(params[k]).to(dev)
            for k in ("cam_unnorm_rots", "cam_trans")}


def _viewer_camera(intrinsics, first_w2c, width, height, view_scale, dev):
    w, h = int(width * view_scale), int(height * view_scale)
    k = np.asarray(intrinsics, dtype=np.float64)[:3, :3].copy() * view_scale
    k[2, 2] = 1.0
    return setup_camera(w, h, k, first_w2c, device=dev)


def _render(gauss, rot, tran, cam, raster_cfg) -> np.ndarray:
    """The fused 6-channel render (RGB, depth, silhouette, depth^2) as a
    (6, H, W) numpy array."""
    out, _ = render_for_loss(gauss, rot, tran, cam, raster_cfg,
                             gaussians_grad=False, camera_grad=False)
    return out.color.cpu().numpy()


def _rgb8(color: np.ndarray) -> np.ndarray:
    return (np.clip(color[:3], 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


@torch.no_grad()
def render_trajectory(
    params: Dict,
    intrinsics: np.ndarray,
    first_w2c: np.ndarray,
    out_dir: str,
    *,
    width: int,
    height: int,
    raster_cfg: RasterConfig = RasterConfig(),
    every: int = 1,
    render_mode: str = "color",  # 'color' | 'depth' | 'sil'
    view_scale: float = 1.0,
    device=None,
) -> List[str]:
    """Replay the estimated trajectory on ``device`` (None means CUDA) and
    save every ``every``-th frame as ``recon_%04d.png``; returns the paths."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cam = _viewer_camera(intrinsics, first_w2c, width, height, view_scale, dev)
    gauss = _gaussians(params, dev)
    traj = _trajectory(params, dev)
    paths = []
    for t in range(0, traj["cam_unnorm_rots"].shape[-1], every):
        out = _render(gauss, *get_pose(traj, t), cam, raster_cfg)
        if render_mode == "depth":
            d = out[3]
            img = (np.clip(d / max(d.max(), 1e-6), 0, 1) * 255).astype(np.uint8)
        elif render_mode == "sil":
            img = (np.clip(out[4], 0, 1) * 255).astype(np.uint8)
        else:
            img = _rgb8(out)
        paths.append(os.path.join(out_dir, f"recon_{t:04d}.png"))
        imwrite(paths[-1], img)
    return paths


@torch.no_grad()
def online_replay(
    params: Dict,
    timestep,
    intrinsics: np.ndarray,
    first_w2c: np.ndarray,
    out_dir: str,
    *,
    width: int,
    height: int,
    keyframe_time_indices=None,
    raster_cfg: RasterConfig = RasterConfig(),
    view_scale: float = 1.0,
    device=None,
) -> List[str]:
    """Per-keyframe online reconstruction replay
    (`viz_scripts/online_recon.py`): for each keyframe time t the map is
    rendered with only the Gaussians made by t (``timestep <= t``) at the
    estimated pose for t, showing the map as SLAM saw it grow. Writes
    ``online_%04d.png`` and returns the paths."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cam = _viewer_camera(intrinsics, first_w2c, width, height, view_scale, dev)
    traj = _trajectory(params, dev)
    if keyframe_time_indices is None:
        keyframe_time_indices = range(traj["cam_unnorm_rots"].shape[-1])
    timestep = torch.as_tensor(timestep)
    paths = []
    for t in keyframe_time_indices:
        t = int(t)
        gauss = _gaussians(params, dev, keep=timestep <= t)
        out = _render(gauss, *get_pose(traj, t), cam, raster_cfg)
        paths.append(os.path.join(out_dir, f"online_{t:04d}.png"))
        imwrite(paths[-1], _rgb8(out))
    return paths


def plot_trajectory(params: Dict, gt_w2c_all: Optional[np.ndarray],
                    out_path: str) -> None:
    """Top-down estimated-vs-ground-truth trajectory plot (needs
    matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.stack([np.linalg.inv(w2c)[:3, 3] for w2c in estimated_w2cs(params)])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(est[:, 0], est[:, 2], "b-", label="estimated")
    if gt_w2c_all is not None:
        gt = np.stack([np.linalg.inv(p)[:3, 3] for p in gt_w2c_all])
        ax.plot(gt[:, 0], gt[:, 2], "g--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


@torch.no_grad()
def _render_view(params, w2c, k, w, h, raster_cfg, render_mode, dev,
                 show_sil=False, keep=None):
    """Render the map from an arbitrary viewer camera; returns (pts, cols)
    for the point-cloud display (`final_recon.py:106-170` render+rgbd2pcd)."""
    if render_mode == "centers":
        pts = torch.as_tensor(params["means3D"]).cpu().numpy()
        cols = torch.as_tensor(params["rgb_colors"]).cpu().numpy()
        if keep is not None:
            pts, cols = pts[keep.cpu().numpy()], cols[keep.cpu().numpy()]
        return pts, np.clip(cols, 0, 1)
    cam = setup_camera(w, h, k, np.eye(4), device=dev)
    w2c_t = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    out = _render(_gaussians(params, dev, keep),
                  matrix_to_quaternion(w2c_t[:3, :3]), w2c_t[:3, 3], cam,
                  raster_cfg)
    color = np.clip(out[:3], 0, 1)
    if show_sil:
        color = np.repeat((1.0 - np.clip(out[4], 0, 1))[None], 3, axis=0)
    return rgbd2pcd(color, out[3:4], np.asarray(w2c), np.asarray(k))


def _open3d(fallback: str):
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError(
            f"open3d is not installed; use {fallback} for headless viz"
        ) from e
    return o3d


def _lineset(o3d, points, lines):
    ls = o3d.geometry.LineSet()
    ls.points = o3d.utility.Vector3dVector(points)
    ls.lines = o3d.utility.Vector2iVector(lines)
    return ls


def interactive_recon(params: Dict, intrinsics, first_w2c, viz_cfg: Dict,
                      raster_cfg: RasterConfig = RasterConfig(), device=None):
    """Open3D interactive reconstruction (`viz_scripts/final_recon.py:
    172-301`): estimated camera frustums and trajectory linesets, and a
    view-control loop that re-renders the splats from the viewer's current
    camera every frame (a re-raster, not a static point cloud). Needs
    open3d and a display; the geometry comes from ``viz/geometry``."""
    o3d = _open3d("render_trajectory")
    dev = resolve_device(device)
    w, h = viz_cfg.get("viz_w", 600), viz_cfg.get("viz_h", 340)
    view_scale = float(viz_cfg.get("view_scale", 2.0))
    render_mode = viz_cfg.get("render_mode", "color")
    show_sil = bool(viz_cfg.get("show_sil", False))
    k = np.asarray(intrinsics, dtype=np.float64)[:3, :3].copy()

    vis = o3d.visualization.Visualizer()
    vis.create_window(
        width=int(w * view_scale), height=int(h * view_scale), visible=True
    )
    pts, cols = _render_view(params, np.asarray(first_w2c), k, w, h,
                             raster_cfg, render_mode, dev, show_sil)
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts)
    pcd.colors = o3d.utility.Vector3dVector(cols)
    vis.add_geometry(pcd)

    if viz_cfg.get("visualize_cams", True):
        geo = scene_geometry(params, w, h, k)
        for f in geo["frustums"]:
            ls = _lineset(o3d, f["points"], f["lines"])
            ls.paint_uniform_color(f["color"])
            vis.add_geometry(ls)
        traj = geo["trajectory"]
        ls = _lineset(o3d, traj["points"], traj["lines"])
        ls.colors = o3d.utility.Vector3dVector(traj["colors"])
        vis.add_geometry(ls)

    # view control seeded from the first camera (`final_recon.py:226-244`)
    view_k = k * view_scale
    view_k[2, 2] = 1.0
    view_control = vis.get_view_control()
    cparams = o3d.camera.PinholeCameraParameters()
    view_w2c = np.asarray(first_w2c, dtype=np.float64).copy()
    if viz_cfg.get("offset_first_viz_cam", True):
        view_w2c[:3, 3] += np.array([0.0, 0.0, 0.5])
    cparams.extrinsic = view_w2c
    cparams.intrinsic.intrinsic_matrix = view_k
    cparams.intrinsic.height = int(h * view_scale)
    cparams.intrinsic.width = int(w * view_scale)
    view_control.convert_from_pinhole_camera_parameters(
        cparams, allow_arbitrary=True
    )
    opts = vis.get_render_option()
    opts.point_size = view_scale
    opts.light_on = False

    # interactive loop: re-render from the live viewer camera each frame
    while True:
        cam_params = view_control.convert_to_pinhole_camera_parameters()
        cur_k = np.asarray(cam_params.intrinsic.intrinsic_matrix) / view_scale
        cur_k[2, 2] = 1.0
        cur_w2c = np.asarray(cam_params.extrinsic)
        pts, cols = _render_view(params, cur_w2c, cur_k, w, h, raster_cfg,
                                 render_mode, dev, show_sil)
        pcd.points = o3d.utility.Vector3dVector(pts)
        pcd.colors = o3d.utility.Vector3dVector(cols)
        vis.update_geometry(pcd)
        if not vis.poll_events():
            break
        vis.update_renderer()
    vis.destroy_window()


def interactive_online_recon(
    params: Dict, timestep, intrinsics, first_w2c, viz_cfg: Dict,
    keyframe_time_indices=None,
    raster_cfg: RasterConfig = RasterConfig(),
    device=None,
):
    """Open3D online reconstruction replay (`viz_scripts/online_recon.py`):
    steps through the keyframe timeline, each step re-rendering the map
    with only the Gaussians made by then (``timestep <= t``), moving the
    current camera's frustum and growing the trajectory lineset; the
    headless PNG analog is ``online_replay``. Needs open3d and a display."""
    o3d = _open3d("online_replay")
    dev = resolve_device(device)
    w, h = viz_cfg.get("viz_w", 600), viz_cfg.get("viz_h", 340)
    view_scale = float(viz_cfg.get("view_scale", 2.0))
    k = np.asarray(intrinsics, dtype=np.float64)[:3, :3].copy()
    w2cs = estimated_w2cs(params)
    num_frames = len(w2cs)
    if keyframe_time_indices is None:
        keyframe_time_indices = range(num_frames)
    fcols = frustum_colors(num_frames)
    timestep = torch.as_tensor(timestep)

    vis = o3d.visualization.Visualizer()
    vis.create_window(
        width=int(w * view_scale), height=int(h * view_scale), visible=True
    )
    pcd = o3d.geometry.PointCloud()
    vis.add_geometry(pcd)
    prev_frustum = prev_lines = None
    centers = []
    for t in keyframe_time_indices:
        t = int(t)
        pts, cols = _render_view(
            params, w2cs[t], k, w, h, raster_cfg,
            viz_cfg.get("render_mode", "color"), dev,
            bool(viz_cfg.get("show_sil", False)), keep=timestep <= t,
        )
        pcd.points = o3d.utility.Vector3dVector(pts)
        pcd.colors = o3d.utility.Vector3dVector(cols)
        vis.update_geometry(pcd)
        # move the current-pose frustum (`online_recon.py:250-255`)
        if prev_frustum is not None:
            vis.remove_geometry(prev_frustum)
        prev_frustum = _lineset(o3d, *camera_frustum_lines(w, h, k, w2cs[t],
                                                           0.045))
        prev_frustum.paint_uniform_color(fcols[t])
        vis.add_geometry(prev_frustum)
        # grow the trajectory polyline
        centers.append(np.linalg.inv(w2cs[t])[:3, 3])
        if len(centers) >= 2:
            if prev_lines is not None:
                vis.remove_geometry(prev_lines)
            tpts, tlines = trajectory_lineset(np.asarray(centers))
            prev_lines = _lineset(o3d, tpts, tlines)
            prev_lines.colors = o3d.utility.Vector3dVector(
                trajectory_colors(len(tlines)))
            vis.add_geometry(prev_lines)
        if not vis.poll_events():
            break
        vis.update_renderer()
    vis.destroy_window()
