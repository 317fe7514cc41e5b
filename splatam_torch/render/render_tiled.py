"""Tile-binned rendering: image and tile-block APIs around the kernels.

Counterpart of ``splatam_tpu/render/render_tiled.py`` (its Pallas path):
preprocess -> binning -> compositing kernels, with the loss-facing outputs
kept in channel-major tile blocks (T, C, 256). ``cfg.layout`` picks the
stream layout and with it the kernels: ``"split"`` (the default) B3a-d,
``"aligned"`` B1/B2.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from splatam_torch.device import resolve_device
from splatam_torch.render.binning import (
    Binned,
    BinnedSplit,
    RasterConfig,
    bin_gaussians_csr,
)
from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import (
    MEDIAN_DEPTH_INIT,
    TILE,
    Projected,
    grid_dims,
    preprocess,
)
from splatam_torch.render.raster import (
    SAT_INF,
    RasterOut,
    pack_attrs,
    rasterize_tiles,
)
from splatam_torch.render.sh import eval_sh


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (C, H, W) features with the background composed
    radius: torch.Tensor  # (N,) int32
    depth: torch.Tensor  # (1, H, W) median depth, 15 where unset
    final_t: torch.Tensor  # (H, W)


class RenderAux(NamedTuple):
    num_instances: int
    # (T,) per-tile saturation depth, +inf where the tile never went fully
    # opaque; feed it back as binning's ``depth_cap``
    sat_depth: torch.Tensor


def blocks_to_image(blocks: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(T, C, 256) channel-major tile blocks -> (C, H, W) image."""
    grid_x, grid_y = grid_dims(cam)
    c = blocks.shape[1]
    img = blocks.reshape(grid_y, grid_x, c, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, grid_y * TILE, grid_x * TILE)
    return img[:, : cam.image_height, : cam.image_width]


def image_to_blocks(img: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(C, H, W) image -> (T, C, 256) channel-major tile blocks, zero-padded."""
    grid_x, grid_y = grid_dims(cam)
    c = img.shape[0]
    img = torch.nn.functional.pad(
        img, (0, grid_x * TILE - img.shape[2], 0, grid_y * TILE - img.shape[1])
    )
    img = img.reshape(c, grid_y, TILE, grid_x, TILE)
    return img.permute(1, 3, 0, 2, 4).reshape(grid_y * grid_x, c, TILE * TILE)


def valid_pixel_blocks(cam: Camera) -> torch.Tensor:
    """(T, 256) f32 1/0 mask of tile-block pixels inside the image."""
    grid_x, grid_y = grid_dims(cam)
    dev = cam.device
    t = torch.arange(grid_y * grid_x, device=dev)
    p = torch.arange(TILE * TILE, device=dev)
    px = (t % grid_x)[:, None] * TILE + (p % TILE)[None, :]
    py = (t // grid_x)[:, None] * TILE + (p // TILE)[None, :]
    return ((px < cam.image_width) & (py < cam.image_height)).float()


def rasterize_tiled_blocks(
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig = RasterConfig(),
    active: torch.Tensor | None = None,
    means2d_dummy: torch.Tensor | None = None,
    binned: Binned | BinnedSplit | None = None,
    grad_feats: int | None = None,
    carry_depth_grad: bool = True,
) -> tuple[RasterOut, RenderAux, Projected]:
    """Render into raw channel-major tile blocks (no image).

    ``binned`` reuses an earlier binning (frozen between rebins), in either
    layout; ``means2d_dummy`` (N, 2) is added to the screen means in NDC
    units, so its gradient is the screen-space gradient Inria
    densification reads;
    ``grad_feats`` / ``carry_depth_grad`` narrow the gradient rows, legal
    only when the caller's loss has zero cotangents for the dropped ones
    (``carry_depth_grad=False`` also zeroes the median-depth primal)."""
    opacities = opacities.reshape(-1)
    proj = preprocess(means3d, scales, rotations, cam, active=active)
    blend_xy = proj.means2d
    if means2d_dummy is not None:
        scale_ndc = torch.tensor(
            [0.5 * cam.image_width, 0.5 * cam.image_height],
            dtype=torch.float32, device=blend_xy.device,
        )
        blend_xy = blend_xy + means2d_dummy * scale_ndc
    if binned is None:
        binned = bin_gaussians_csr(proj, cam, cfg, opacities=opacities)
    nfeat = colors.shape[-1]
    attrs = pack_attrs(blend_xy, proj.conic, opacities, proj.depths, colors)
    grid_x, _ = grid_dims(cam)
    res = rasterize_tiles(
        attrs, binned, grid_x, cfg.chunk,
        nfeat=nfeat if grad_feats is None else grad_feats,
        carry_depth=carry_depth_grad,
    )
    sat_raw = res.aux[:, 2, 0].detach()
    sat = torch.where(sat_raw < SAT_INF, sat_raw, torch.full_like(sat_raw, float("inf")))
    return res, RenderAux(num_instances=binned.num_instances, sat_depth=sat), proj


def assemble_image(res: RasterOut, proj: Projected, nfeat: int, cam: Camera):
    """Raw tile blocks -> (color with background, median depth, final T)."""
    color_img = blocks_to_image(res.color, cam)
    aux_img = blocks_to_image(res.aux, cam)
    final_t = aux_img[1]
    bg = torch.zeros(nfeat, dtype=torch.float32, device=color_img.device)
    k = min(nfeat, cam.bg.shape[0])
    bg[:k] = cam.bg[:k]
    color = color_img[:nfeat] + final_t[None] * bg[:, None, None]
    depth = torch.where(
        aux_img[0] > 0.0, aux_img[0], torch.full_like(aux_img[0], MEDIAN_DEPTH_INIT)
    )
    return RenderOutput(color=color, radius=proj.radius, depth=depth[None],
                        final_t=final_t)


def rasterize_tiled(
    means3d,
    colors,
    opacities,
    scales,
    rotations,
    cam: Camera,
    cfg: RasterConfig = RasterConfig(),
    active=None,
    means2d_dummy=None,
    binned: Binned | BinnedSplit | None = None,
    device=None,
    shs=None,
    sh_degree: int = 0,
) -> tuple[RenderOutput, RenderAux]:
    """Render features (any F <= 8 channels; the first three blend against
    ``cam.bg``, the rest against 0) plus median depth and final T.

    ``shs`` ((N, K, 3) spherical-harmonics coefficients, K >= (degree + 1)^2)
    gives view-dependent RGB, evaluated per Gaussian at ``cam.campos``
    (``render/sh.eval_sh``) before binning: it replaces ``colors`` where
    they are None, else comes before them as the first three channels.

    Runs on ``device`` (None means CUDA; it raises when CUDA is absent).
    Inputs may be numpy arrays or tensors; they are moved to the device."""
    dev = resolve_device(device)
    if cam.device != dev:
        raise ValueError(f"camera lives on {cam.device}, render asked for {dev}")

    def on(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(dev, torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    act = None if active is None else torch.as_tensor(active, device=dev)
    means3d, colors = on(means3d), on(colors)
    if shs is not None:
        sh_rgb = eval_sh(sh_degree, on(shs), means3d, cam.campos)
        colors = sh_rgb if colors is None else torch.cat([sh_rgb, colors], -1)
    res, aux, proj = rasterize_tiled_blocks(
        means3d, colors, on(opacities), on(scales), on(rotations), cam,
        cfg, active=act, means2d_dummy=on(means2d_dummy), binned=binned,
    )
    return assemble_image(res, proj, colors.shape[-1], cam), aux
