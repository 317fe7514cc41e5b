"""SLAM losses: silhouette-masked L1 photometric + depth, SSIM.

Counterpart of ``splatam_tpu/core/losses.py`` (`get_loss`,
`scripts/splatam.py:220-353`; `calc_ssim`, `utils/slam_external.py:54-98`).
RGB, depth, silhouette and depth^2 are rendered in one fused 6-channel pass,
and the loss runs in the kernels' tile layout (``_slam_loss_blocks`` in the
JAX package): the ground-truth frame is moved into tile blocks instead of
the render into an image, except for the RGB channels that SSIM filters.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from splatam_torch.core.transforms import normalize, transform_to_frame
from splatam_torch.render.binning import Binned, RasterConfig, bin_gaussians_csr
from splatam_torch.render.camera import Camera
from splatam_torch.render.geometry import preprocess
from splatam_torch.render.render_tiled import (
    blocks_to_image,
    image_to_blocks,
    rasterize_tiled_blocks,
    assemble_image,
    valid_pixel_blocks,
)


def l1_loss_v1(x, y):
    return (x - y).abs().mean()


def calc_psnr(img1, img2):
    mse = ((img1 - img2) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=None)
def _gauss_window(window_size: int, sigma: float, channels: int,
                  device: torch.device, dtype: torch.dtype = torch.float32):
    """The depthwise SSIM window, built once per (size, sigma, channels,
    device, dtype): building it is a host-to-device copy the caller would
    otherwise wait on at every call."""
    g = torch.tensor(
        [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
         for x in range(window_size)],
        dtype=dtype, device=device,
    )
    g = g / g.sum()
    return (g[:, None] @ g[None, :]).expand(channels, 1, window_size, window_size)


def calc_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """SSIM over (C, H, W) images: 11x11 Gaussian window, sigma 1.5, zero
    'same' padding (a depthwise F.conv2d, as in the reference)."""
    c = img1.shape[0]
    win = _gauss_window(window_size, 1.5, c, img1.device, img1.dtype)

    def conv(x):
        return F.conv2d(x[None], win, padding=window_size // 2, groups=c)[0]

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def depth_silhouette_colors(pts_cam: torch.Tensor, viewmatrix: torch.Tensor):
    """Per-Gaussian [z, 1, z^2] channels (`utils/slam_helpers.py:196-213`)."""
    z = pts_cam @ viewmatrix[2, :3] + viewmatrix[2, 3]
    return torch.stack([z, torch.ones_like(z), z * z], dim=-1)


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the middle two averaged (numpy/JAX rule)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _frame_inputs(params, cam_rot, cam_tran, gaussians_grad, camera_grad):
    iso = params["log_scales"].shape[1] == 1
    log_scales = params["log_scales"]
    if iso:
        log_scales = log_scales.expand(-1, 3)
    pts, rots, _ = transform_to_frame(
        params["means3D"], params["unnorm_rotations"], cam_rot, cam_tran,
        transform_rots=not iso, gaussians_grad=gaussians_grad,
        camera_grad=camera_grad,
    )
    return pts, normalize(rots), torch.exp(log_scales)


class LossOutput(NamedTuple):
    loss: torch.Tensor
    losses: Dict[str, torch.Tensor]
    radius: torch.Tensor  # (N,) int32; seen = radius > 0
    sat_depth: torch.Tensor  # (T,) pass to the next compute_binned(depth_cap=)


def render_for_loss(
    params, cam_rot, cam_tran, cam: Camera, cfg: RasterConfig,
    gaussians_grad: bool, camera_grad: bool, means2d_dummy=None,
    binned: Binned | None = None,
):
    """Transform to the frame + fused 6-channel render, image layout."""
    pts, rots, scales = _frame_inputs(
        params, cam_rot, cam_tran, gaussians_grad, camera_grad
    )
    feats = torch.cat(
        [params["rgb_colors"], depth_silhouette_colors(pts, cam.viewmatrix)],
        dim=-1,
    )
    res, aux, proj = rasterize_tiled_blocks(
        pts, feats, torch.sigmoid(params["logit_opacities"]), scales, rots,
        cam, cfg, means2d_dummy=means2d_dummy, binned=binned,
    )
    return assemble_image(res, proj, feats.shape[-1], cam), aux


@torch.no_grad()
def compute_binned(params, cam_rot, cam_tran, cam: Camera, cfg: RasterConfig,
                   depth_cap: torch.Tensor | None = None) -> Binned:
    """Bin the scene at a pose, for reuse over several iterations (frozen
    binning): Adam steps move poses millimeters and Gaussians little, so
    tile membership and depth order hold while the blend stays exact."""
    pts, rots, scales = _frame_inputs(params, cam_rot, cam_tran, False, False)
    proj = preprocess(pts, scales, rots, cam)
    return bin_gaussians_csr(
        proj, cam, cfg, opacities=torch.sigmoid(params["logit_opacities"]),
        depth_cap=depth_cap,
    )


@torch.no_grad()
def count_instances(params, cam_rot, cam_tran, cam: Camera) -> int:
    """Total (gaussian, tile) pairs the render at this pose expands to."""
    pts, rots, scales = _frame_inputs(params, cam_rot, cam_tran, False, False)
    return int(preprocess(pts, scales, rots, cam).tiles_touched.sum())


def slam_loss(
    params: Dict[str, torch.Tensor],
    cam_rot: torch.Tensor,
    cam_tran: torch.Tensor,
    frame_im: torch.Tensor,  # (3, H, W) in [0, 1]
    frame_depth: torch.Tensor,  # (1, H, W)
    cam: Camera,
    cfg: RasterConfig,
    *,
    tracking: bool,
    do_ba: bool = False,
    loss_w_im: float,
    loss_w_depth: float,
    use_sil_for_loss: bool,
    sil_thres: float,
    ignore_outlier_depth_loss: bool,
    means2d_dummy: torch.Tensor | None = None,
    median_scale: float = 50.0,
    median_thr: float | None = None,
    binned: Binned | None = None,
) -> LossOutput:
    """`get_loss` parity. tracking=True: pose-only gradients, per-pixel sums
    over the silhouette mask. tracking=False (mapping): Gaussian-only
    gradients, mean L1 depth + 0.8 L1 / 0.2 DSSIM RGB. ``do_ba`` (bundle
    adjustment, `scripts/splatam.py:232-238`) lets the mapping loss carry
    camera-pose gradients too.

    ``median_scale`` / ``median_thr`` shape the outlier-depth mask:
    error < (median_scale / 5) * median(error), the median capped at
    ``median_thr`` (then the scale is 10)."""
    pts, rots, scales = _frame_inputs(
        params, cam_rot, cam_tran, gaussians_grad=not tracking,
        camera_grad=tracking or do_ba,
    )
    feats = torch.cat(
        [params["rgb_colors"], depth_silhouette_colors(pts, cam.viewmatrix)],
        dim=-1,
    )
    # only RGB and the blended depth carry cotangents: the silhouette and
    # depth^2 channels feed detached masks, the median depth is unused
    res, aux, proj = rasterize_tiled_blocks(
        pts, feats, torch.sigmoid(params["logit_opacities"]), scales, rots,
        cam, cfg, means2d_dummy=means2d_dummy, binned=binned,
        grad_feats=4, carry_depth_grad=False,
    )
    blocks = res.color
    t_fin = res.aux[:, 1]
    im_t = blocks[:, :3] + t_fin[:, None, :] * cam.bg[None, :3, None]
    depth_t = blocks[:, 3]
    sil_t = blocks[:, 4]
    uncertainty_t = (blocks[:, 5] - depth_t * depth_t).detach()

    valid_t = valid_pixel_blocks(cam)
    gt_im_t = image_to_blocks(frame_im, cam)
    gt_depth_t = image_to_blocks(frame_depth, cam)[:, 0]

    with torch.no_grad():
        nan_mask = ~torch.isnan(depth_t) & ~torch.isnan(uncertainty_t)
        depth_error = (gt_depth_t - depth_t).abs() * (gt_depth_t > 0)
        if ignore_outlier_depth_loss:
            err = torch.where(valid_t > 0, depth_error,
                              torch.full_like(depth_error, float("inf")))
            hw = cam.image_height * cam.image_width
            flat = torch.sort(err.reshape(-1)).values
            med = 0.5 * (flat[(hw - 1) // 2] + flat[hw // 2])
            scale = median_scale / 5.0
            if median_thr is not None:
                scale = torch.where(med > median_thr, 10.0, scale)
                med = torch.clamp(med, max=median_thr)
            mask = (depth_error < scale * med) & (gt_depth_t > 0)
        else:
            mask = gt_depth_t > 0
        mask = mask & nan_mask
        if tracking and use_sil_for_loss:
            mask = mask & (sil_t > sil_thres)
        maskf = mask.float()

    losses = {}
    depth_abs = (gt_depth_t - depth_t).abs()
    if tracking:
        losses["depth"] = (depth_abs * maskf).sum()
    else:
        losses["depth"] = (depth_abs * maskf).sum() / torch.clamp(
            mask.sum(), min=1
        )
    rgb_abs = (gt_im_t - im_t).abs()
    if tracking and (use_sil_for_loss or ignore_outlier_depth_loss):
        losses["im"] = (rgb_abs * maskf[:, None, :]).sum()
    elif tracking:
        losses["im"] = (rgb_abs * valid_t[:, None, :]).sum()
    else:
        im_img = blocks_to_image(im_t, cam)
        losses["im"] = 0.8 * l1_loss_v1(im_img, frame_im) + 0.2 * (
            1.0 - calc_ssim(im_img, frame_im)
        )
    loss = loss_w_im * losses["im"] + loss_w_depth * losses["depth"]
    losses["loss"] = loss
    return LossOutput(
        loss=loss, losses=losses, radius=proj.radius, sat_depth=aux.sat_depth,
    )
