"""Absolute trajectory error via Horn closed-form alignment.

Counterpart of ``splatam_tpu/eval/ate.py`` (`utils/eval_helpers.py:23-77`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from splatam_torch.core.params import get_pose
from splatam_torch.core.transforms import pose_to_w2c


def align(model: np.ndarray, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align two trajectories (3, N) with the method of Horn.

    Returns (rot 3x3, trans 3x1, per-point translation error (N,))."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err * err, axis=0))


def evaluate_ate(gt_traj: Sequence[np.ndarray], est_traj: Sequence[np.ndarray]) -> float:
    """Mean translational alignment error between two lists of 4x4 w2c
    poses (the reference names it RMSE but takes the mean)."""
    gt_pts = np.stack([np.asarray(p)[:3, 3] for p in gt_traj]).T
    est_pts = np.stack([np.asarray(p)[:3, 3] for p in est_traj]).T
    _, _, trans_error = align(gt_pts, est_pts)
    return float(trans_error.mean())


def trajectory_from_params(params, first_w2c: np.ndarray, gt_w2c_list: List[np.ndarray]):
    """(gt, est) pose lists as the reference's eval builds them: frame 0
    uses first_w2c; NaN ground-truth poses are skipped."""
    num_frames = params["cam_unnorm_rots"].shape[-1]
    est = [np.asarray(first_w2c)]
    gt = [np.asarray(gt_w2c_list[0])]
    for idx in range(1, min(num_frames, len(gt_w2c_list))):
        if np.isnan(gt_w2c_list[idx]).any():
            continue
        est.append(pose_to_w2c(*get_pose(params, idx)).cpu().numpy())
        gt.append(np.asarray(gt_w2c_list[idx]))
    return gt, est
