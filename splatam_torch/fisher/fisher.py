"""Diagonal Fisher information of the rendered image w.r.t. map parameters.

Counterpart of ``splatam_tpu/fisher/fisher.py`` (the reference fork's
Hessian rasterizer + ROS active-view-selection math):

- ``render_fisher``: ``compute_Hessian`` (`scripts/ros_handler.py:839-902`),
  the RGB render seeded with 1e-3 per channel and the per-pixel gradients
  squared before they are summed, H = [F(means3D) || F(opacity)], (N, 4);
- ``h_train_inverse`` / ``fisher_h_train``: ``compute_H_visited_inv``
  (`ros_handler.py:807-829`), 1 / (sum of per-pose H + 0.1);
- ``eig_score``: sum(H * H_train_inv) (`ros_handler.py:832-836`);
- ``render_gains`` / ``silhouette_gain`` / ``nonlinear_gain``: the
  per-candidate gains (`ros_handler.py:251-359`).

Kernel B4 (render/raster.py ``fisher_moments``) emits per gaussian the
second moments M = sum_p v v^T of the screen-space gradients v = d/d(x, y,
conic a, b, c) and sum_p (d/dopacity)^2; the chain to the 3D means is
closed here as diag(J^T M J) with J the per-gaussian projection Jacobian,
which is exact because J does not depend on the pixel.

The Fisher path always bins in the aligned layout, whatever
``RasterConfig.layout`` says (``fisher_config``): B4 runs on aligned tile
ranges. The JAX package's static capacities, overflow flags and padded pose
batches have no counterpart here: the signatures stay, ``overflow`` is
always False, and the batch functions loop over the poses whose weight is
not zero.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from splatam_torch.core.losses import depth_silhouette_colors
from splatam_torch.core.transforms import normalize, transform_to_frame
from splatam_torch.render.binning import RasterConfig, bin_gaussians_csr
from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import compute_cov3d, grid_dims, preprocess
from splatam_torch.render.raster import (
    NFEAT_PAD,
    TRI_PAIRS,
    fisher_moments,
    pack_attrs,
)
from splatam_torch.render.render_tiled import (
    rasterize_tiled_blocks,
    valid_pixel_blocks,
)

def _gaussian_frame(params: Dict[str, torch.Tensor], cam_rot, cam_tran):
    """Camera-frame gaussians (pts, rots, scales, opacities) from raw
    params, detached."""
    iso = params["log_scales"].shape[1] == 1
    log_scales = params["log_scales"]
    if iso:
        log_scales = log_scales.expand(-1, 3)
    pts, rots, _ = transform_to_frame(
        params["means3D"], params["unnorm_rotations"], cam_rot, cam_tran,
        transform_rots=not iso, gaussians_grad=False, camera_grad=False,
    )
    return (pts, normalize(rots), torch.exp(log_scales).detach(),
            torch.sigmoid(params["logit_opacities"]).reshape(-1).detach())


def _projection_jacobian(pts, cov3d, cam: Camera, active):
    """(N, 5, 3) d(x, y, conic a, b, c)/d(mean3d), per gaussian: three
    forward-mode tangent passes through ``preprocess`` with ``cov3d`` held
    fixed (it does not depend on the mean)."""
    pts = pts.detach()
    cols = []
    for d in range(3):
        tangent = torch.zeros_like(pts)
        tangent[:, d] = 1.0
        with fwAD.dual_level():
            pr = preprocess(fwAD.make_dual(pts, tangent), None, None, cam,
                            active=active, cov3d_precomp=cov3d)
            out = torch.cat([pr.means2d, pr.conic], dim=1)  # (N, 5)
            cols.append(fwAD.unpack_dual(out).tangent)
    return torch.stack(cols, dim=2)


def fisher_config(cfg: RasterConfig) -> RasterConfig:
    """The configuration the Fisher path bins with: always aligned, since
    B4 runs on aligned tile ranges."""
    if cfg.layout != "aligned":
        return dataclasses.replace(cfg, layout="aligned")
    return cfg


def _seed(seed_value: float, device) -> torch.Tensor:
    seed = torch.zeros(NFEAT_PAD, dtype=torch.float32, device=device)
    seed[:3] = seed_value
    return seed


@torch.no_grad()
def render_fisher(
    params: Dict[str, torch.Tensor],
    active,
    cam_rot: torch.Tensor,
    cam_tran: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    seed_value: float = 1e-3,
    binned=None,
    with_overflow: bool = False,
    tile_color=None,
):
    """Diagonal Fisher H = [F(means3D) || F(opacity)] per gaussian, (N, 4).

    The RGB render is seeded with ``seed_value`` per channel and every
    per-pixel gradient is squared before the sum over pixels. ``binned``
    (aligned) shares a binning with a same-pose silhouette render, and
    ``tile_color`` that render's forward color blocks, so the gains path
    runs one forward per candidate. ``active`` (N,) bool or None (every
    row) masks rows; inactive rows get zero. ``with_overflow=True`` returns
    ``(h, False)``."""
    pts, rots, scales, opac = _gaussian_frame(params, cam_rot, cam_tran)
    colors = params["rgb_colors"].detach()
    cov3d = compute_cov3d(scales, rots, cam.scale_modifier)
    proj = preprocess(pts, None, None, cam, active=active, cov3d_precomp=cov3d)
    if binned is None:
        binned = bin_gaussians_csr(proj, cam, fisher_config(cfg),
                                   opacities=opac)
    attrs = pack_attrs(proj.means2d, proj.conic, opac, proj.depths, colors)
    grid_x, _ = grid_dims(cam)
    mom = fisher_moments(attrs, binned, grid_x, cfg.chunk,
                         _seed(seed_value, pts.device), tile_color=tile_color)

    # F_d = (J^T M J)_dd per gaussian, folded as
    # sum_{a<=b} (2 - [a == b]) M_ab J_ad J_bd
    jac = _projection_jacobian(pts, cov3d, cam, active)  # (N, 5, 3)
    f_mean = torch.zeros_like(pts)
    for row, (a, b) in enumerate(TRI_PAIRS):
        w = mom[:, row] if a == b else 2.0 * mom[:, row]
        f_mean = f_mean + w[:, None] * jac[:, a, :] * jac[:, b, :]
    h = torch.cat([f_mean, mom[:, 15:16]], dim=-1)
    if active is not None:
        h = torch.where(torch.as_tensor(active, device=h.device)[:, None], h,
                        torch.zeros_like(h))
    if with_overflow:
        return h, False
    return h


def sized_fisher_config(params, active, cam_rot, cam_tran, cam: Camera,
                        base: RasterConfig, margin: float = 1.6
                        ) -> RasterConfig:
    """The Fisher configuration for ``base``. The JAX package sizes static
    capacities from a probe binning here; tensors in the port take the
    sizes the data gives them, so only the layout changes."""
    return fisher_config(base)


def _weighted(weights):
    """Indices of the poses whose weight is not zero."""
    return torch.nonzero(torch.as_tensor(weights).cpu()).flatten().tolist()


@torch.no_grad()
def fisher_h_train(
    params: Dict[str, torch.Tensor],
    active,
    rots,  # (P, 4) w2c rotations as quaternions
    trans,  # (P, 3)
    weights,  # (P,) 0/1; poses of weight 0 are skipped
    cam: Camera,
    cfg: RasterConfig,
    seed_value: float = 1e-3,
):
    """sum_i weights[i] * Fisher(pose_i), the Monte-Carlo sum of
    ``compute_H_visited_inv``. Returns (h_train (N, 4), False)."""
    dev = params["means3D"].device
    rots, trans = torch.as_tensor(rots, device=dev), torch.as_tensor(trans, device=dev)
    wgt = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    h_train = torch.zeros((params["means3D"].shape[0], 4), device=dev)
    for i in _weighted(weights):
        h = render_fisher(params, active, rots[i], trans[i], cam, cfg,
                          seed_value=seed_value)
        h_train = h_train + wgt[i] * h
    return h_train, False


@torch.no_grad()
def render_gains(
    params: Dict[str, torch.Tensor],
    active,
    cam_rot: torch.Tensor,
    cam_tran: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    h_train_inv: torch.Tensor | None = None,
    seed_value: float = 1e-3,
):
    """One candidate pose -> (g_sil_raw, g_eig_raw, overflow=False).

    One aligned binning and one forward (B1) serve both the silhouette
    count and, when ``h_train_inv`` is given, the Fisher moments (B4), which
    read that forward's color blocks. The silhouette gain counts
    silhouette < 0.5 over the tile blocks' pixels inside the image, over
    W * H."""
    cfg_fisher = fisher_config(cfg)
    pts, rots, scales, opac = _gaussian_frame(params, cam_rot, cam_tran)
    proj = preprocess(pts, scales, rots, cam, active=active)
    binned = bin_gaussians_csr(proj, cam, cfg_fisher, opacities=opac)
    feats = torch.cat(
        [params["rgb_colors"].detach(),
         depth_silhouette_colors(pts, cam.viewmatrix)], dim=-1,
    )
    res, _, _ = rasterize_tiled_blocks(
        pts, feats, opac, scales, rots, cam, cfg_fisher, active=active,
        binned=binned,
    )
    sil_blk = res.color[:, 4, :]  # (T, NPIX) tile-layout silhouette
    g_sil = ((sil_blk < 0.5) & (valid_pixel_blocks(cam) > 0)).sum() / (
        cam.image_width * cam.image_height)
    if h_train_inv is None:
        g_eig = torch.zeros((), device=pts.device)
    else:
        h = render_fisher(params, active, cam_rot, cam_tran, cam, cfg,
                          seed_value=seed_value, binned=binned,
                          tile_color=res.color)
        g_eig = (h * h_train_inv).sum()
    return g_sil.float(), g_eig, False


@torch.no_grad()
def fisher_gains_batch(
    params: Dict[str, torch.Tensor],
    active,
    rots,  # (P, 4) w2c rotations as quaternions
    trans,  # (P, 3)
    weights,  # (P,) 0/1; poses of weight 0 are skipped (their gains are 0)
    cam: Camera,
    cfg: RasterConfig,
    h_train_inv: torch.Tensor | None = None,
    seed_value: float = 1e-3,
):
    """``render_gains`` over a batch of candidate poses. Returns
    (g_sil (P,), g_eig (P,), False)."""
    dev = params["means3D"].device
    rots, trans = torch.as_tensor(rots, device=dev), torch.as_tensor(trans, device=dev)
    p = rots.shape[0]
    sils = torch.zeros(p, device=dev)
    eigs = torch.zeros(p, device=dev)
    for i in _weighted(weights):
        sils[i], eigs[i], _ = render_gains(params, active, rots[i], trans[i],
                                           cam, cfg, h_train_inv, seed_value)
    return sils, eigs, False


def h_train_inverse(
    hessians: Sequence[np.ndarray],
    monte_carlo: int | None = 40,
    rng: np.random.Generator | None = None,
    eps: float = 0.1,
) -> np.ndarray:
    """``compute_H_visited_inv``: the per-pose Hessians (Monte-Carlo
    subsampled to at most ``monte_carlo`` poses) summed, then 1 / (H + eps)."""
    hessians = list(hessians)
    if monte_carlo is not None and len(hessians) > monte_carlo:
        rng = rng or np.random.default_rng(0)
        idx = rng.choice(len(hessians), monte_carlo, replace=False)
        hessians = [hessians[i] for i in idx]
    h_train = np.sum(np.stack(hessians, axis=0), axis=0)
    return 1.0 / (h_train + eps)


def eig_score(h_pose: torch.Tensor, h_train_inv: torch.Tensor) -> torch.Tensor:
    """Expected information gain: sum(H_pose * H_train_inv)."""
    return (h_pose * h_train_inv).sum()


def silhouette_gain(silhouette: torch.Tensor, k_sil: float = 1.0) -> torch.Tensor:
    """Fraction of unmapped pixels (silhouette < 0.5), times ``k_sil``."""
    h, w = silhouette.shape[-2:]
    return (silhouette < 0.5).sum() / (h * w) * k_sil


def nonlinear_gain(x, scale: float = 3400.0, rate: float = 0.002):
    """Optional sigmoid squashing of a gain (`ros_handler.py:314-318`)."""
    x = torch.as_tensor(x)
    return scale / (1.0 + torch.exp(-rate * x)) - scale / 2.0
