"""Pure-numpy geometry builders for the interactive reconstruction viewer.

The port's copy of ``splatam_tpu/viz/geometry.py``
(`viz_scripts/final_recon.py:26-301` / `online_recon.py`): camera frustum
wireframes (`o3d.geometry.LineSet.create_camera_visualization` analog),
trajectory linesets (`final_recon.py:94-104` make_lineset), and the
'cool'-colormap coloring of both. Open3D only consumes these arrays
(``viz/recon.py``'s interactive paths); everything here runs headless. The
trajectory may be tensors on any device or numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from splatam_torch.core.params import get_pose
from splatam_torch.core.transforms import pose_to_w2c


def camera_frustum_lines(
    w: int, h: int, k: np.ndarray, w2c: np.ndarray, scale: float = 0.045
) -> Tuple[np.ndarray, np.ndarray]:
    """Frustum wireframe for one camera: (points (5, 3), lines (8, 2)).

    The o3d `LineSet.create_camera_visualization(w, h, k, w2c, scale)`
    analog used per estimated pose (`final_recon.py:196-204`): the camera
    center plus the four image corners unprojected to depth ``scale``,
    connected center->corner (4) and around the image plane (4).
    """
    k = np.asarray(k, dtype=np.float64)[:3, :3]
    w2c = np.asarray(w2c, dtype=np.float64)
    c2w = np.linalg.inv(w2c)
    corners_px = np.array(
        [[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]], dtype=np.float64
    )
    ones = np.ones((4, 1))
    rays = np.linalg.inv(k) @ np.concatenate([corners_px, ones], axis=1).T
    cam_pts = np.concatenate(
        [np.zeros((3, 1)), rays * scale], axis=1
    )  # (3, 5): center + corners at depth `scale`
    world = (c2w[:3, :3] @ cam_pts).T + c2w[:3, 3]
    lines = np.array(
        [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]],
        dtype=np.int32,
    )
    return world, lines


def trajectory_lineset(
    points: np.ndarray, num_lines: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Consecutive-point line indices for a camera trajectory polyline.

    make_lineset analog (`final_recon.py:94-104`): for points laid out as
    ``num_lines`` interleaved polylines, line i connects point i to point
    i - num_lines (the default num_lines=1 is the plain consecutive chain).
    Returns (points, lines (P - num_lines, 2)).
    """
    points = np.ascontiguousarray(points, dtype=np.float64)
    idx = np.arange(len(points))
    lines = np.stack([idx, idx - num_lines], axis=-1)[num_lines:]
    return points, lines.astype(np.int32)


def cool_colormap(t: np.ndarray) -> np.ndarray:
    """matplotlib 'cool' colormap, closed form: rgb = (t, 1-t, 1)."""
    t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
    return np.stack([t, 1.0 - t, np.ones_like(t)], axis=-1)


def frustum_colors(num_t: int, norm_factor: float = 0.5) -> np.ndarray:
    """(num_t, 3) per-pose frustum colors (`final_recon.py:199-203`)."""
    i = np.arange(max(num_t, 1), dtype=np.float64)
    return cool_colormap(i * norm_factor / max(num_t, 1))[:num_t]


def trajectory_colors(num_segments: int, norm_factor: float = 0.5) -> np.ndarray:
    """(num_segments, 3) per-line colors (`final_recon.py:210-217`)."""
    i = np.arange(max(num_segments, 1), dtype=np.float64)
    return cool_colormap(
        i * norm_factor / max(num_segments, 1) + norm_factor
    )[:num_segments]


def estimated_w2cs(params: Dict, num_t: int | None = None) -> List[np.ndarray]:
    """Per-timestep estimated w2c matrices from the camera trajectory
    params (`final_recon.py:59-67` load_scene_data)."""
    traj = {k: torch.as_tensor(params[k]).detach().cpu()
            for k in ("cam_unnorm_rots", "cam_trans")}
    if num_t is None:
        num_t = int(traj["cam_unnorm_rots"].shape[-1])
    return [
        pose_to_w2c(*get_pose(traj, t)).numpy().astype(np.float64)
        for t in range(num_t)
    ]


def scene_geometry(
    params: Dict,
    w: int,
    h: int,
    k: np.ndarray,
    frustum_size: float = 0.045,
    num_t: int | None = None,
) -> Dict:
    """All viewer geometry in plain arrays: per-pose frustums (points,
    lines, color) plus the camera-center trajectory polyline — the
    `visualize_cams` block of `final_recon.py:194-224` without Open3D."""
    w2cs = estimated_w2cs(params, num_t)
    fcols = frustum_colors(len(w2cs))
    frustums = []
    centers = []
    for i, w2c in enumerate(w2cs):
        pts, lines = camera_frustum_lines(w, h, k, w2c, frustum_size)
        frustums.append({"points": pts, "lines": lines, "color": fcols[i]})
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.asarray(centers)
    tpts, tlines = trajectory_lineset(centers)
    return {
        "frustums": frustums,
        "trajectory": {
            "points": tpts,
            "lines": tlines,
            "colors": trajectory_colors(len(tlines)),
        },
        "w2cs": w2cs,
    }
