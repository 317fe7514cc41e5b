"""Camera model (counterpart of ``splatam_tpu/render/camera.py``).

An OpenGL-style projection matrix built from pinhole intrinsics, composed
with a world-to-camera matrix: ``p_view = w2c @ p``, ``p_hom = proj @ w2c @ p``.
The matrices are built in float64 with numpy and stored as float32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from splatam_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    viewmatrix: torch.Tensor  # (4, 4) world-to-camera
    projmatrix: torch.Tensor  # (4, 4) opengl_proj @ w2c
    campos: torch.Tensor  # (3,) camera center in the world frame
    bg: torch.Tensor  # (3,) background color
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    scale_modifier: float = 1.0

    @property
    def focal_x(self) -> float:
        return self.image_width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.image_height / (2.0 * self.tanfovy)

    @property
    def device(self) -> torch.device:
        return self.viewmatrix.device


def opengl_projection(
    w: int, h: int, fx: float, fy: float, cx: float, cy: float,
    near: float = 0.01, far: float = 100.0,
) -> np.ndarray:
    return np.array(
        [
            [2 * fx / w, 0.0, -(w - 2 * cx) / w, 0.0],
            [0.0, 2 * fy / h, -(h - 2 * cy) / h, 0.0],
            [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=np.float64,
    )


def _pose_tensors(w: int, h: int, k, w2c, near, far, dev):
    k = np.asarray(k, dtype=np.float64)
    w2c_np = np.asarray(w2c, dtype=np.float64)
    fx, fy, cx, cy = k[0][0], k[1][1], k[0][2], k[1][2]
    proj = opengl_projection(w, h, fx, fy, cx, cy, near, far) @ w2c_np
    center = np.linalg.inv(w2c_np)[:3, 3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return t(w2c_np), t(proj), t(center)


def setup_camera(
    w: int, h: int, k, w2c, near: float = 0.01, far: float = 100.0,
    bg: Tuple[float, float, float] = (0.0, 0.0, 0.0), device=None,
) -> Camera:
    """Camera from intrinsics ``k`` (3x3) and a 4x4 ``w2c``."""
    dev = resolve_device(device)
    k = np.asarray(k, dtype=np.float64)
    view, proj, center = _pose_tensors(w, h, k, w2c, near, far, dev)
    return Camera(
        viewmatrix=view,
        projmatrix=proj,
        campos=center,
        bg=torch.tensor(bg, dtype=torch.float32, device=dev),
        image_height=int(h),
        image_width=int(w),
        tanfovx=float(w / (2.0 * k[0][0])),
        tanfovy=float(h / (2.0 * k[1][1])),
    )


def replace_pose(cam: Camera, k, w2c) -> Camera:
    """Same intrinsics and device, new extrinsic ``w2c``."""
    view, proj, center = _pose_tensors(
        cam.image_width, cam.image_height, k, w2c, 0.01, 100.0, cam.device
    )
    return dataclasses.replace(
        cam, viewmatrix=view, projmatrix=proj, campos=center
    )
