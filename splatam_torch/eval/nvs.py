"""Novel-view-synthesis evaluation with hole-validity masking.

Counterpart of ``splatam_tpu/eval/nvs.py`` (`eval_nvs`,
`utils/eval_helpers.py:641-855`): renders the map at the ground-truth poses
of a test split (ReplicaV2, ScanNet++), skips the first frame (the train
split's first, which the loaders prepend), and marks a view invalid when
more than 0.1% of its pixels have valid depth and no silhouette
(`eval_helpers.py:725-731`). Each view is one fused 6-channel render
(``core/losses.render_for_loss``, no gradient), as in ``eval/runner``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from splatam_torch.core.losses import render_for_loss
from splatam_torch.core.params import GAUSSIAN_KEYS
from splatam_torch.core.transforms import matrix_to_quaternion
from splatam_torch.device import resolve_device
from splatam_torch.eval.lpips import load_lpips
from splatam_torch.eval.metrics import ms_ssim, psnr
from splatam_torch.eval.runner import _gt_frame
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera


@torch.no_grad()
def eval_nvs(
    dataset,
    final_params: Dict,
    num_frames: int,
    eval_dir: str,
    sil_thres: float,
    mapping_iters: int,
    add_new_gaussians: bool,
    eval_every: int = 1,
    raster_cfg: RasterConfig = RasterConfig(),
    lpips_weights: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Evaluate the final map at the test poses of ``dataset`` on
    ``device`` (None means CUDA). Writes ``nvs_{psnr,rmse,l1,ssim,lpips,
    valid}.txt`` to ``eval_dir`` and returns the means, over every view and
    over the valid views. With neither mapping iterations nor new
    Gaussians (a tracking-only run), the metrics count only the pixels
    inside the silhouette."""
    dev = resolve_device(device)
    os.makedirs(eval_dir, exist_ok=True)
    lpips_fn = load_lpips(lpips_weights, dev)
    tracking_only = mapping_iters == 0 and not add_new_gaussians
    gauss = {k: final_params[k].to(dev) for k in GAUSSIAN_KEYS}

    psnr_list, ssim_list, lpips_list = [], [], []
    rmse_list, l1_list = [], []
    valid_frames: List[bool] = []
    cam = None

    for time_idx in range(num_frames):
        color, depth, intrinsics, pose = dataset[time_idx]
        gt_w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
        if time_idx == 0:
            cam = setup_camera(
                np.asarray(color).shape[1], np.asarray(color).shape[0],
                np.asarray(intrinsics)[:3, :3], gt_w2c, device=dev,
            )
            continue  # the first train frame is not a novel view
        test_idx = time_idx - 1
        if test_idx != 0 and (test_idx + 1) % eval_every != 0:
            continue

        im_gt, depth_gt = _gt_frame(color, depth, dev)
        w2c = torch.as_tensor(gt_w2c, dtype=torch.float32, device=dev)
        out, _ = render_for_loss(
            gauss, matrix_to_quaternion(w2c[:3, :3]), w2c[:3, 3], cam,
            raster_cfg, gaussians_grad=False, camera_grad=False)
        im = out.color[:3]
        rastered_depth = out.color[3:4]
        silhouette = out.color[4]

        valid_depth_mask = depth_gt > 0
        presence_sil_mask = silhouette > sil_thres
        rastered_depth_m = rastered_depth * valid_depth_mask

        # hole-validity rule (`eval_helpers.py:725-731`)
        valid_region = presence_sil_mask[None] | ~valid_depth_mask
        percent_holes = float((~valid_region).sum()) / valid_region.numel() * 100
        valid_frames.append(percent_holes <= 0.1)

        if tracking_only:
            w_im = im * presence_sil_mask[None] * valid_depth_mask
            w_gt = im_gt * presence_sil_mask[None] * valid_depth_mask
        else:
            w_im = im * valid_depth_mask
            w_gt = im_gt * valid_depth_mask
        psnr_list.append(float(psnr(w_im, w_gt)))
        ssim_list.append(float(ms_ssim(w_im, w_gt)))
        lpips_list.append(
            float(lpips_fn(w_im.clamp(0, 1), w_gt.clamp(0, 1)))
            if lpips_fn is not None else float("nan")
        )
        diff = rastered_depth_m - depth_gt
        if tracking_only:
            diff = diff * presence_sil_mask[None]
        denom = torch.clamp(valid_depth_mask.sum(), min=1)
        rmse_list.append(
            float(torch.sqrt(((diff**2) * valid_depth_mask).sum() / denom)))
        l1_list.append(float((diff.abs() * valid_depth_mask).sum() / denom))

    valid = np.array(valid_frames)

    def avg(vals, mask=None):
        vals = np.array(vals)
        if mask is not None:
            vals = vals[mask]
        return float(np.mean(vals)) if len(vals) else float("nan")

    results = {
        "psnr": avg(psnr_list),
        "ms_ssim": avg(ssim_list),
        "lpips": avg(lpips_list),
        "depth_rmse": avg(rmse_list),
        "depth_l1": avg(l1_list),
        "valid_frac": float(valid.mean()) if len(valid) else float("nan"),
        "psnr_valid": avg(psnr_list, valid),
        "ms_ssim_valid": avg(ssim_list, valid),
        "lpips_valid": avg(lpips_list, valid),
    }
    for name, vals in [
        ("psnr", psnr_list), ("rmse", rmse_list), ("l1", l1_list),
        ("ssim", ssim_list), ("lpips", lpips_list),
        ("valid", valid.astype(np.float64)),
    ]:
        np.savetxt(os.path.join(eval_dir, f"nvs_{name}.txt"), np.array(vals))
    print(
        f"NVS: PSNR {results['psnr']:.2f} (valid {results['psnr_valid']:.2f}) | "
        f"MS-SSIM {results['ms_ssim']:.3f} | valid frames "
        f"{results['valid_frac'] * 100:.0f}%"
    )
    return results
