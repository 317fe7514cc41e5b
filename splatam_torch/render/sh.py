"""Spherical-harmonics (degree <= 3) view-dependent colour.

Counterpart of ``splatam_tpu/render/sh.py`` (the reference rasterizer's
``computeColorFromSH``, `cuda_rasterizer/forward.cu:20-71`, constants
`auxiliary.h:22-39`): the view direction is the normalised
(mean - campos), the DC band is offset by +0.5 and the result clamped at 0,
and the clamp gates the gradient as `backward.cu:107-121` does
(``torch.clamp``'s gradient is zero where it clamped). It runs per Gaussian
before binning, so the colour reaches the kernels as any feature does.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(
    degree: int,
    shs: torch.Tensor,  # (N, K, 3) with K >= (degree + 1)^2
    means3d: torch.Tensor,  # (N, 3) in the frame of campos
    campos: torch.Tensor,  # (3,)
) -> torch.Tensor:
    """(N, 3) RGB from SH coefficients at each Gaussian's view direction."""
    if not 0 <= degree <= 3:
        raise ValueError(f"sh degree must be 0..3, got {degree}")
    need = num_sh_coeffs(degree)
    if shs.shape[1] < need:
        raise ValueError(
            f"degree {degree} needs {need} coefficients, shs has {shs.shape[1]}"
        )
    d = means3d - campos[None, :]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    result = SH_C0 * shs[:, 0]
    if degree > 0:
        result = (
            result
            - SH_C1 * y * shs[:, 1]
            + SH_C1 * z * shs[:, 2]
            - SH_C1 * x * shs[:, 3]
        )
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (
            result
            + SH_C2[0] * xy * shs[:, 4]
            + SH_C2[1] * yz * shs[:, 5]
            + SH_C2[2] * (2.0 * zz - xx - yy) * shs[:, 6]
            + SH_C2[3] * xz * shs[:, 7]
            + SH_C2[4] * (xx - yy) * shs[:, 8]
        )
    if degree > 2:
        result = (
            result
            + SH_C3[0] * y * (3.0 * xx - yy) * shs[:, 9]
            + SH_C3[1] * xy * z * shs[:, 10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[:, 11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[:, 12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[:, 13]
            + SH_C3[5] * z * (xx - yy) * shs[:, 14]
            + SH_C3[6] * x * (xx - 3.0 * yy) * shs[:, 15]
        )
    return torch.clamp(result + 0.5, min=0.0)


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC band: the Inria PLY convention (rgb - 0.5) / C0."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    return dc * SH_C0 + 0.5
