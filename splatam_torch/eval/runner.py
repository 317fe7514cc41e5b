"""Final-map evaluation: per-frame renders, PSNR/MS-SSIM/LPIPS/depth, ATE.

Counterpart of ``splatam_tpu/eval/runner.py`` (`eval`,
`utils/eval_helpers.py:408-638`): the same masks (valid depth; the
silhouette too when the run only tracked), per-frame metric lists written
as txt, and the Horn-aligned trajectory error. Each frame is one fused
6-channel render (``core/losses.render_for_loss``, no gradient), so on the
card it launches B1 in the aligned layout, B3a and B3b in the split one.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from splatam_torch.core.losses import render_for_loss
from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose
from splatam_torch.data.base import imwrite
from splatam_torch.device import resolve_device
from splatam_torch.eval.ate import evaluate_ate, trajectory_from_params
from splatam_torch.eval.lpips import load_lpips
from splatam_torch.eval.metrics import ms_ssim, psnr
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera


def _qual_plot(plot_dir, time_idx, im_gt, im, d_gt, d, sil, psnr_val):
    """Per-frame qualitative 2x3 figure grid (`eval_helpers.py:109-149`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(2, 3, figsize=(11, 6))
    ax[0, 0].imshow(np.clip(im_gt.transpose(1, 2, 0), 0, 1))
    ax[0, 0].set_title("GT RGB")
    ax[0, 1].imshow(np.clip(im.transpose(1, 2, 0), 0, 1))
    ax[0, 1].set_title(f"Rendered RGB (PSNR {psnr_val:.1f})")
    ax[0, 2].imshow(sil, cmap="gray", vmin=0, vmax=1)
    ax[0, 2].set_title("Silhouette")
    vmax = max(float(d_gt.max()), 1e-6)
    ax[1, 0].imshow(d_gt, cmap="viridis", vmin=0, vmax=vmax)
    ax[1, 0].set_title("GT depth")
    ax[1, 1].imshow(d, cmap="viridis", vmin=0, vmax=vmax)
    ax[1, 1].set_title("Rendered depth")
    ax[1, 2].imshow(np.abs(d - d_gt) * (d_gt > 0), cmap="magma")
    ax[1, 2].set_title("Depth L1")
    for a in ax.ravel():
        a.axis("off")
    fig.savefig(
        os.path.join(plot_dir, f"{time_idx:04d}.png"), dpi=90,
        bbox_inches="tight",
    )
    plt.close(fig)


def _gt_frame(color, depth, dev):
    im = torch.as_tensor(
        (np.transpose(np.asarray(color), (2, 0, 1)) / 255.0).astype(np.float32),
        device=dev)
    d = torch.as_tensor(
        np.transpose(np.asarray(depth), (2, 0, 1)).astype(np.float32),
        device=dev)
    return im, d


def _save_frames(eval_dir, time_idx, im, rastered_depth):
    """The rendered color as an 8-bit RGB PNG and the depth, scaled to its
    largest value, as a 16-bit PNG (with imageio, else Pillow)."""
    rdir = os.path.join(eval_dir, "rendered_rgb")
    os.makedirs(rdir, exist_ok=True)
    imwrite(
        os.path.join(rdir, f"gs_{time_idx:04d}.png"),
        (np.clip(im, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8),
    )
    ddir = os.path.join(eval_dir, "rendered_depth")
    os.makedirs(ddir, exist_ok=True)
    d = rastered_depth[0]
    imwrite(
        os.path.join(ddir, f"gs_{time_idx:04d}.png"),
        (np.clip(d / max(float(d.max()), 1e-6), 0, 1) * 65535).astype(np.uint16),
    )


@torch.no_grad()
def eval_sequence(
    dataset,
    final_params: Dict,
    num_frames: int,
    eval_dir: str,
    sil_thres: float,
    mapping_iters: int,
    add_new_gaussians: bool,
    eval_every: int = 1,
    raster_cfg: RasterConfig = RasterConfig(),
    save_frames: bool = False,
    save_plots: bool = False,
    lpips_weights: Optional[str] = None,
    eig_fn=None,
    log_fn=None,
    device=None,
) -> Dict[str, float]:
    """Evaluate the final map on ``device`` (None means CUDA).

    ``eig_fn(rot, tran, cam) -> float`` optionally scores each evaluated
    pose's expected information gain (the reference's per-frame
    `ros_handler.compute_eig_score`, `utils/eval_helpers.py:489-496`);
    ``log_fn`` receives per-frame metric dicts (a wandb-style sink,
    `eval_helpers.py:598-609`). The results also hold ``frames``, the
    number of frames rendered."""
    dev = resolve_device(device)
    os.makedirs(eval_dir, exist_ok=True)
    plot_dir = None
    if save_plots:
        plot_dir = os.path.join(eval_dir, "plots")
        os.makedirs(plot_dir, exist_ok=True)
    lpips_fn = load_lpips(lpips_weights, dev)
    params = {k: v.to(dev) for k, v in final_params.items()}
    gauss = {k: params[k] for k in GAUSSIAN_KEYS}

    psnr_list, rmse_list, l1_list, ssim_list, lpips_list = [], [], [], [], []
    eig_list: List[float] = []
    gt_w2c_list: List[np.ndarray] = []
    first_w2c = None
    cam = None
    tracking_only = mapping_iters == 0 and not add_new_gaussians

    for time_idx in range(num_frames):
        color, depth, intrinsics, pose = dataset[time_idx]
        gt_w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
        gt_w2c_list.append(gt_w2c)
        if time_idx == 0:
            first_w2c = gt_w2c
            cam = setup_camera(
                np.asarray(color).shape[1], np.asarray(color).shape[0],
                np.asarray(intrinsics)[:3, :3], first_w2c, device=dev,
            )
        if time_idx != 0 and (time_idx + 1) % eval_every != 0:
            continue

        im_gt, depth_gt = _gt_frame(color, depth, dev)
        rot_t, tran_t = get_pose(params, time_idx)
        out, _ = render_for_loss(gauss, rot_t, tran_t, cam, raster_cfg,
                                 gaussians_grad=False, camera_grad=False)
        im = out.color[:3]
        rastered_depth = out.color[3:4]
        silhouette = out.color[4]

        valid_depth_mask = depth_gt > 0
        presence_sil_mask = silhouette > sil_thres
        rastered_depth_m = rastered_depth * valid_depth_mask

        if tracking_only:
            weighted_im = im * presence_sil_mask[None] * valid_depth_mask
            weighted_gt = im_gt * presence_sil_mask[None] * valid_depth_mask
        else:
            weighted_im = im * valid_depth_mask
            weighted_gt = im_gt * valid_depth_mask
        psnr_list.append(float(psnr(weighted_im, weighted_gt)))
        ssim_list.append(float(ms_ssim(weighted_im, weighted_gt)))
        if lpips_fn is not None:
            lpips_list.append(float(lpips_fn(weighted_im.clamp(0, 1),
                                             weighted_gt.clamp(0, 1))))
        else:
            lpips_list.append(float("nan"))

        # the reference's "depth RMSE" is sqrt((d)^2) elementwise, i.e. the
        # same masked-mean L1 (`utils/eval_helpers.py:500-514`); kept for
        # metric parity
        diff = rastered_depth_m - depth_gt
        if tracking_only:
            diff = diff * presence_sil_mask[None]
        denom = torch.clamp(valid_depth_mask.sum(), min=1)
        l1 = float((diff.abs() * valid_depth_mask).sum() / denom)
        rmse_list.append(l1)
        l1_list.append(l1)
        if eig_fn is not None:
            eig_list.append(float(eig_fn(rot_t, tran_t, cam)))
        if log_fn is not None:
            log_fn(
                {
                    "Eval/PSNR": psnr_list[-1],
                    "Eval/MS-SSIM": ssim_list[-1],
                    "Eval/LPIPS": lpips_list[-1],
                    "Eval/Depth L1": l1_list[-1],
                    "Eval/frame": time_idx,
                    **({"Eval/EIG": eig_list[-1]} if eig_list else {}),
                }
            )
        if save_frames:
            _save_frames(eval_dir, time_idx, im.cpu().numpy(),
                         rastered_depth.cpu().numpy())
        if plot_dir is not None:
            _qual_plot(
                plot_dir, time_idx,
                im_gt.cpu().numpy(), im.cpu().numpy(),
                depth_gt[0].cpu().numpy(), rastered_depth[0].cpu().numpy(),
                silhouette.cpu().numpy(), float(psnr_list[-1]),
            )

    try:
        gt, est = trajectory_from_params(params, first_w2c, gt_w2c_list)
        ate_rmse = evaluate_ate(gt, est)
    except Exception:
        ate_rmse = 100.0

    results = {
        "ate_rmse": ate_rmse,
        "psnr": float(np.mean(psnr_list)),
        "ms_ssim": float(np.mean(ssim_list)),
        "lpips": float(np.mean(lpips_list)),
        "depth_rmse": float(np.mean(rmse_list)),
        "depth_l1": float(np.mean(l1_list)),
    }
    if eig_list:
        results["eig"] = float(np.mean(eig_list))

    for name, vals in [
        ("psnr", psnr_list), ("rmse", rmse_list), ("l1", l1_list),
        ("ssim", ssim_list), ("lpips", lpips_list), ("eig", eig_list),
    ]:
        if vals or name != "eig":
            np.savetxt(os.path.join(eval_dir, f"{name}.txt"), np.array(vals))
    print(
        f"ATE RMSE: {ate_rmse*100:.2f} cm | PSNR: {results['psnr']:.2f} | "
        f"MS-SSIM: {results['ms_ssim']:.3f} | Depth L1: {results['depth_l1']*100:.2f} cm"
    )
    results["frames"] = len(psnr_list)
    return results


@torch.no_grad()
def eval_online(
    dataset,
    all_params: List[Dict],
    num_frames: int,
    eval_online_dir: str,
    sil_thres: float,
    mapping_iters: int,
    add_new_gaussians: bool,
    eval_every: int = 1,
    raster_cfg: RasterConfig = RasterConfig(),
    save_plots: bool = False,
    device=None,
) -> Dict[str, float]:
    """Online evaluation (`utils/eval_helpers.py:279-405`): each frame is
    rendered with the map AS IT WAS at that time step (``all_params`` holds
    per-timestep snapshots), measuring reconstruction quality during the
    run rather than of the final map. Writes per-frame PSNR / depth RMSE /
    depth L1 lists and returns their averages."""
    dev = resolve_device(device)
    os.makedirs(eval_online_dir, exist_ok=True)
    plot_dir = None
    if save_plots:
        plot_dir = os.path.join(eval_online_dir, "plots")
        os.makedirs(plot_dir, exist_ok=True)

    psnr_list, rmse_list, l1_list = [], [], []
    tracking_only = mapping_iters == 0 and not add_new_gaussians
    cam = None
    for time_idx in range(num_frames):
        color, depth, intrinsics, pose = dataset[time_idx]
        if time_idx == 0:
            first_w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
            cam = setup_camera(
                np.asarray(color).shape[1], np.asarray(color).shape[0],
                np.asarray(intrinsics)[:3, :3], first_w2c, device=dev,
            )
        if time_idx != 0 and (time_idx + 1) % eval_every != 0:
            continue
        params = {k: v.to(dev) for k, v in all_params[time_idx].items()}
        im_gt, depth_gt = _gt_frame(color, depth, dev)
        rot_t, tran_t = get_pose(params, time_idx)
        out, _ = render_for_loss({k: params[k] for k in GAUSSIAN_KEYS},
                                 rot_t, tran_t, cam, raster_cfg,
                                 gaussians_grad=False, camera_grad=False)
        im = out.color[:3]
        rastered_depth = out.color[3:4]
        silhouette = out.color[4]
        valid_depth_mask = depth_gt > 0
        presence_sil_mask = silhouette > sil_thres
        if tracking_only:
            weighted_im = im * presence_sil_mask[None]
            weighted_gt = im_gt * presence_sil_mask[None]
        else:
            weighted_im, weighted_gt = im, im_gt
        psnr_list.append(float(psnr(weighted_im, weighted_gt)))
        diff = rastered_depth - depth_gt
        if tracking_only:
            diff = diff * presence_sil_mask[None]
        denom = torch.clamp(valid_depth_mask.sum(), min=1)
        rmse_list.append(
            float(torch.sqrt(((diff * valid_depth_mask) ** 2).sum() / denom))
        )
        l1_list.append(float((diff.abs() * valid_depth_mask).sum() / denom))
        if plot_dir is not None:
            _qual_plot(
                plot_dir, time_idx, im_gt.cpu().numpy(), im.cpu().numpy(),
                depth_gt[0].cpu().numpy(), rastered_depth[0].cpu().numpy(),
                silhouette.cpu().numpy(), psnr_list[-1],
            )

    results = {
        "psnr": float(np.mean(psnr_list)),
        "depth_rmse": float(np.mean(rmse_list)),
        "depth_l1": float(np.mean(l1_list)),
    }
    for name, vals in [
        ("psnr", psnr_list), ("rmse", rmse_list), ("l1", l1_list),
    ]:
        np.savetxt(os.path.join(eval_online_dir, f"{name}.txt"), np.array(vals))
    print(
        f"Online: PSNR {results['psnr']:.2f} | Depth RMSE "
        f"{results['depth_rmse']*100:.2f} cm | Depth L1 "
        f"{results['depth_l1']*100:.2f} cm"
    )
    return results
