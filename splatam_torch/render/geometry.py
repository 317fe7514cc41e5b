"""Per-Gaussian projection geometry, the "preprocess" stage.

Counterpart of ``splatam_tpu/render/geometry.py`` (itself the reference CUDA
preprocess, `forward.cu:20-256`): near cull at z <= 0.001, w-epsilon 1e-7,
field-of-view clamp 1.3 tan(fov), low-pass +0.3 on the 2D covariance,
eigenvalue floor 0.1, radius = ceil(3 sqrt(lambda_max)), and ndc2pix
``((v + 1) S - 1) / 2``. Plain tensor code; autograd gives the backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatam_torch.render.camera import Camera

TILE = 16
ALPHA_CAP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
MEDIAN_DEPTH_INIT = 15.0


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coords
    depths: torch.Tensor  # (N,) camera-frame z
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # (N,) int32 screen radius, 0 => culled
    rect_min: torch.Tensor  # (N, 2) int32 tile rect min (x, y), inclusive
    rect_max: torch.Tensor  # (N, 2) int32 tile rect max (x, y), exclusive
    tiles_touched: torch.Tensor  # (N,) int32

    def detach(self) -> "Projected":
        return Projected(*(t.detach() for t in self))


def _unit(q: torch.Tensor) -> torch.Tensor:
    # the max sits inside the sqrt so a zero quaternion has a zero gradient
    return q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-24))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix, (..., 4) -> (..., 3, 3)."""
    q = _unit(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov3d(
    scales: torch.Tensor, rotations: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T packed (xx, xy, xz, yy, yz, zz), (N, 6)."""
    q = _unit(rotations)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scales * scale_modifier
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    return torch.stack(
        [
            s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02,
            s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12,
            s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22,
            s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12,
            s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22,
            s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22,
        ],
        dim=-1,
    )


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    viewmatrix: torch.Tensor,
    focal_x: float, focal_y: float, tan_fovx: float, tan_fovy: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """EWA-splatting 2D covariance (N, 3) = (cxx, cxy, cyy)."""
    W = viewmatrix[:3, :3]
    t = means3d @ W.T + viewmatrix[:3, 3]
    tz = t[:, 2]
    if valid is not None:
        # culled rows never contribute; 1 keeps their gradients finite
        tz = torch.where(valid, tz, torch.ones_like(tz))
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    xx, xy, xz, yy, yz, zz = (cov3d[:, i] for i in range(6))

    def ventry(a, b):
        wa, wb = W[a], W[b]
        return (
            wa[0] * wb[0] * xx + wa[1] * wb[1] * yy + wa[2] * wb[2] * zz
            + (wa[0] * wb[1] + wa[1] * wb[0]) * xy
            + (wa[0] * wb[2] + wa[2] * wb[0]) * xz
            + (wa[1] * wb[2] + wa[2] * wb[1]) * yz
        )

    v00, v01, v02 = ventry(0, 0), ventry(0, 1), ventry(0, 2)
    v11, v12, v22 = ventry(1, 1), ventry(1, 2), ventry(2, 2)

    cxx = j00 * j00 * v00 + 2 * j00 * j02 * v02 + j02 * j02 * v22
    cxy = j00 * j11 * v01 + j00 * j12 * v02 + j02 * j11 * v12 + j02 * j12 * v22
    cyy = j11 * j11 * v11 + 2 * j11 * j12 * v12 + j12 * j12 * v22
    return torch.stack([cxx + 0.3, cxy, cyy + 0.3], dim=-1)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def grid_dims(cam: Camera) -> tuple[int, int]:
    """(grid_x, grid_y): tiles across and down the image."""
    return (cam.image_width + TILE - 1) // TILE, (cam.image_height + TILE - 1) // TILE


def preprocess(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3)
    rotations: torch.Tensor,  # (N, 4) normalized (w, x, y, z)
    cam: Camera,
    active: torch.Tensor | None = None,  # (N,) bool; inactive rows are culled
    cov3d_precomp: torch.Tensor | None = None,  # (N, 6); then scales and
    # rotations are not read
) -> Projected:
    """Project Gaussians to screen space; cull; conics and tile rects."""
    grid_x, grid_y = grid_dims(cam)

    p_view = means3d @ cam.viewmatrix[:3, :3].T + cam.viewmatrix[:3, 3]
    depths = p_view[:, 2]
    valid = depths > 0.001
    if active is not None:
        valid = valid & active

    p_hom = means3d @ cam.projmatrix[:3, :3].T + cam.projmatrix[:3, 3]
    wclip = means3d @ cam.projmatrix[3, :3] + cam.projmatrix[3, 3]
    p_w = 1.0 / torch.where(valid, wclip + 1e-7, torch.ones_like(wclip))
    p_proj = p_hom * p_w[:, None]
    mean_x = ndc2pix(p_proj[:, 0], cam.image_width)
    mean_y = ndc2pix(p_proj[:, 1], cam.image_height)
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    if cov3d_precomp is None:
        cov3d = compute_cov3d(scales, rotations, cam.scale_modifier)
    else:
        cov3d = cov3d_precomp
    cov2d = compute_cov2d(
        means3d, cov3d, cam.viewmatrix, cam.focal_x, cam.focal_y,
        cam.tanfovx, cam.tanfovy, valid=valid,
    )

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    nonzero = det != 0.0
    valid = valid & nonzero
    det_inv = torch.where(
        nonzero, 1.0 / torch.where(nonzero, det, torch.ones_like(det)),
        torch.zeros_like(det),
    )
    conic = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv, cov2d[:, 0] * det_inv],
        dim=-1,
    )

    with torch.no_grad():
        mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
        lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
        radius = radius_f.to(torch.int32)
        mx, my = mean_x.detach(), mean_y.detach()

        def tile_idx(v, hi):
            return torch.clamp(torch.floor(v / TILE).to(torch.int32), 0, hi)

        rx0 = tile_idx(mx - radius_f, grid_x)
        ry0 = tile_idx(my - radius_f, grid_y)
        rx1 = tile_idx(mx + radius_f + TILE - 1, grid_x)
        ry1 = tile_idx(my + radius_f + TILE - 1, grid_y)
        tiles_touched = (rx1 - rx0) * (ry1 - ry0)
        valid = valid & (tiles_touched > 0)
        zero = torch.zeros_like(radius)
        radius = torch.where(valid, radius, zero)
        tiles_touched = torch.where(valid, tiles_touched, zero)
    return Projected(
        means2d=means2d,
        depths=depths,
        conic=conic,
        radius=radius,
        rect_min=torch.stack([rx0, ry0], dim=-1),
        rect_max=torch.stack([rx1, ry1], dim=-1),
        tiles_touched=tiles_touched,
    )


def mark_visible(means3d: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(N,) bool: view-space depth clears the near cull."""
    p_view = means3d @ cam.viewmatrix[:3, :3].T + cam.viewmatrix[:3, 3]
    return p_view[:, 2] > 0.001
