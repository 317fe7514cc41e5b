"""Dense reference rasterizer: the differentiable oracle.

Counterpart of ``splatam_tpu/render/reference.py``: an O(N * H * W)
plain-PyTorch rendering with the exact forward semantics of the reference
CUDA renderer (`cuda_rasterizer/forward.cu:261-393`), in closed form:

  * depth-stable order (ascending camera z, ties by Gaussian index);
  * a Gaussian reaches a pixel only if the pixel's tile lies in its rect;
  * power > 0 is clamped to 0, alpha capped at 0.99 and dropped below
    1/255;
  * hard stop: the first contribution that would take the transmittance
    below 1e-4 is dropped, with everything behind it;
  * median depth where T crosses 0.5, else 15.0.

Autograd through it is the expected backward. It is for small scenes and
tests; no main path runs it.
"""
from __future__ import annotations

import torch

from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import (
    ALPHA_CAP,
    ALPHA_MIN,
    MEDIAN_DEPTH_INIT,
    T_STOP,
    TILE,
    preprocess,
)
from splatam_torch.render.render_tiled import RenderOutput


def rasterize_dense(
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,  # (N,) or (N, 1)
    scales: torch.Tensor,
    rotations: torch.Tensor,
    cam: Camera,
    active: torch.Tensor | None = None,
) -> RenderOutput:
    opacities = opacities.reshape(-1)
    proj = preprocess(means3d, scales, rotations, cam, active=active)
    h, w = cam.image_height, cam.image_width
    dev = means3d.device

    valid = proj.radius > 0
    # ascending depth, invalid rows last; a stable sort keeps ties in index
    # order (the reference's radix sort over (tile, depth) keys)
    sort_depth = torch.where(valid, proj.depths.detach(),
                             torch.full_like(proj.depths, float("inf")))
    order = torch.sort(sort_depth, stable=True).indices

    s_mean2d = proj.means2d[order]
    s_conic = proj.conic[order]
    s_opacity = opacities[order]
    s_color = colors[order]
    s_depth = proj.depths[order]
    s_rect_min = proj.rect_min[order]
    s_rect_max = proj.rect_max[order]
    s_valid = valid[order]

    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")  # (H, W)
    tile_x = (torch.arange(w, device=dev) // TILE)[None, :]  # (1, W)
    tile_y = (torch.arange(h, device=dev) // TILE)[:, None]  # (H, 1)

    dx = s_mean2d[:, 0][:, None, None] - px[None]  # (N, H, W)
    dy = s_mean2d[:, 1][:, None, None] - py[None]
    a = s_conic[:, 0][:, None, None]
    b = s_conic[:, 1][:, None, None]
    c = s_conic[:, 2][:, None, None]
    # power is clamped to <= 0 rather than dropped when > 0: for the
    # positive-definite conics of the low-pass filter, power > 0 only comes
    # from rounding next to the mean, where the reference keeps alpha ~ op
    power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy,
                        max=0.0)

    in_rect = (
        (tile_x[None] >= s_rect_min[:, 0][:, None, None])
        & (tile_x[None] < s_rect_max[:, 0][:, None, None])
        & (tile_y[None] >= s_rect_min[:, 1][:, None, None])
        & (tile_y[None] < s_rect_max[:, 1][:, None, None])
    )

    alpha = torch.clamp(s_opacity[:, None, None] * torch.exp(power),
                        max=ALPHA_CAP)
    contributes = s_valid[:, None, None] & in_rect & (alpha >= ALPHA_MIN)
    alpha = torch.where(contributes, alpha, torch.zeros_like(alpha))

    # transmittance before and after each contribution, front to back
    one_minus = 1.0 - alpha
    t_after = torch.cumprod(one_minus, dim=0)
    t_before = torch.cat([torch.ones_like(t_after[:1]), t_after[:-1]], dim=0)
    live = t_after >= T_STOP  # the hard stop; monotone along the order

    weight = alpha * t_before * live
    color = torch.einsum("nhw,nc->chw", weight, s_color)
    final_t = torch.prod(torch.where(live, one_minus,
                                     torch.ones_like(one_minus)), dim=0)
    color = color + final_t[None] * cam.bg[:, None, None]

    crossing = (t_before > 0.5) & (t_after < 0.5) & live
    depth = torch.where(crossing, s_depth[:, None, None],
                        torch.zeros_like(s_depth[:, None, None])).sum(0)
    depth = depth + MEDIAN_DEPTH_INIT * (~crossing.any(0)).float()
    return RenderOutput(color=color, radius=proj.radius, depth=depth[None],
                        final_t=final_t)
