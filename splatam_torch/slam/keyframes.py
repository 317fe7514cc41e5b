"""Overlap-based keyframe selection (host-side numpy).

Counterpart of ``splatam_tpu/slam/keyframes.py``
(`keyframe_selection_overlap`, `utils/keyframe_selection.py:40-96`): sample
valid-depth pixels, back-project, re-project into each keyframe, rank by the
fraction landing inside (20 px margin, z > 0), randomly permute the
positive-overlap set. Origin points (zero depth) are filtered directly.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def keyframe_selection_overlap(
    gt_depth: np.ndarray,  # (1, H, W)
    w2c: np.ndarray,  # (4, 4) current estimated pose
    intrinsics: np.ndarray,  # (3, 3)
    keyframe_list: List[Dict],
    k: int,
    pixels: int = 1600,
    rng: np.random.Generator | None = None,
) -> List[int]:
    rng = rng or np.random.default_rng()
    h, w = gt_depth.shape[1], gt_depth.shape[2]
    fx, fy = intrinsics[0][0], intrinsics[1][1]
    cx, cy = intrinsics[0][2], intrinsics[1][2]

    valid = np.argwhere(gt_depth[0] > 0)
    if len(valid) == 0:
        return []
    sampled = valid[rng.integers(0, len(valid), pixels)]

    xx = (sampled[:, 1] - cx) / fx
    yy = (sampled[:, 0] - cy) / fy
    z = gt_depth[0, sampled[:, 0], sampled[:, 1]]
    pts_cam = np.stack([xx * z, yy * z, z], axis=-1)
    c2w = np.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    pts = pts[np.abs(np.round(pts, 4)).sum(axis=-1) > 0]

    scored = []
    for kf_id, kf in enumerate(keyframe_list):
        est_w2c = np.asarray(kf["est_w2c"])
        tp = pts @ est_w2c[:3, :3].T + est_w2c[:3, 3]
        p2d = tp @ intrinsics.T
        pz = p2d[:, 2:] + 1e-5
        uv = p2d[:, :2] / pz
        edge = 20
        inside = (
            (uv[:, 0] < w - edge) & (uv[:, 0] > edge)
            & (uv[:, 1] < h - edge) & (uv[:, 1] > edge)
            & (pz[:, 0] > 0)
        )
        scored.append(
            {"id": kf_id, "percent_inside": inside.mean() if len(uv) else 0.0}
        )
    scored = sorted(scored, key=lambda s: s["percent_inside"], reverse=True)
    positive = [s["id"] for s in scored if s["percent_inside"] > 0.0]
    return [int(i) for i in rng.permutation(np.array(positive, dtype=np.int64))[:k]]
