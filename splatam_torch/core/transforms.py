"""Rigid-transform and quaternion utilities.

Counterpart of ``splatam_tpu/core/transforms.py``. Quaternions are
(w, x, y, z). Gradient gating uses ``detach`` where the JAX package uses
``stop_gradient``.
"""
from __future__ import annotations

import torch

from splatam_torch.render.geometry import quat_to_rotmat


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """v / max(||v||, eps), with the max inside the sqrt (zero-safe grads)."""
    n = torch.sqrt(torch.clamp((v * v).sum(dim, keepdim=True), min=eps * eps))
    return v / n


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (..., 4) x (..., 4)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), w first."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    ), min=0.0))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return torch.gather(candidates, -2, idx)[..., 0, :]


def pose_to_w2c(cam_rot_unnorm: torch.Tensor, cam_tran: torch.Tensor) -> torch.Tensor:
    """(4,) unnormalized quat + (3,) translation -> 4x4 w2c matrix."""
    rot = quat_to_rotmat(normalize(cam_rot_unnorm.reshape(4)))
    w2c = torch.eye(4, dtype=torch.float32, device=rot.device)
    w2c[:3, :3] = rot
    w2c[:3, 3] = cam_tran.reshape(3)
    return w2c


def transform_to_frame(
    means3d: torch.Tensor,  # (N, 3) world frame
    unnorm_rotations: torch.Tensor,  # (N, 4)
    cam_rot_unnorm: torch.Tensor,  # (4,) or (1, 4)
    cam_tran: torch.Tensor,  # (3,) or (1, 3)
    transform_rots: bool,
    gaussians_grad: bool = True,
    camera_grad: bool = False,
):
    """Gaussians from the world frame to the camera frame.

    Tracking optimizes the pose only (``gaussians_grad=False``), mapping the
    Gaussians only (``camera_grad=False``); the other side is detached.
    Returns (means (N, 3), unnormalized rotations (N, 4), rel_w2c (4, 4)).
    """
    cam_rot = normalize(cam_rot_unnorm.reshape(4))
    cam_t = cam_tran.reshape(3)
    if not camera_grad:
        cam_rot, cam_t = cam_rot.detach(), cam_t.detach()
    if not gaussians_grad:
        means3d, unnorm_rotations = means3d.detach(), unnorm_rotations.detach()

    rot = quat_to_rotmat(cam_rot)
    pts = means3d @ rot.T + cam_t
    if transform_rots:
        rots = quat_mult(cam_rot[None, :], normalize(unnorm_rotations))
    else:
        rots = unnorm_rotations
    rel_w2c = torch.eye(4, dtype=torch.float32, device=pts.device)
    rel_w2c[:3, :3] = rot
    rel_w2c[:3, 3] = cam_t
    return pts, rots, rel_w2c
