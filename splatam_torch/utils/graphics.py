"""Inria-style camera and projection helpers.

Counterpart of ``splatam_tpu/utils/graphics.py`` (`utils/graphics_utils.py`:
getProjectionMatrix, focal2fov, fov2focal), the port's own numpy copy. The
renders build their projection in ``render/camera.py``.
"""
from __future__ import annotations

import math

import numpy as np


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov * 0.5))


def get_projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """Symmetric-frustum OpenGL projection (`graphics_utils.py`)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    p = np.zeros((4, 4))
    z_sign = 1.0
    p[0, 0] = 2.0 * znear / (right - left)
    p[1, 1] = 2.0 * znear / (top - bottom)
    p[0, 2] = (right + left) / (right - left)
    p[1, 2] = (top + bottom) / (top - bottom)
    p[3, 2] = z_sign
    p[2, 2] = z_sign * zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p
