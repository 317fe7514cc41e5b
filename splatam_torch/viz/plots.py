"""Experiment plotting utilities: occupancy grids, gain curves, PSNR
scatter, the tracking-loss figure.

The port's copy of ``splatam_tpu/viz/plots.py`` (`utils/plot_utils.py`:
make_occupancy_grid/grid_to_cv2, plot_pose_gains, plot_value_psnr,
plot_eig_psnr_slice, plot_combined_psnr; the `running_metrics_*.csv`
format `scripts/get_monte_plot.py` consumes; the tracking-loss figure of
`scripts/splatam.py:299-344`). Pure numpy + matplotlib (Agg): no cv2, no
torch, no display; matplotlib is imported only when a figure is drawn.
"""
from __future__ import annotations

import glob
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def make_occupancy_grid(
    xyz: np.ndarray,
    init_pose: np.ndarray,
    z_slice: float = 0.50,
    z_tol: float = 0.10,
    cell: float = 0.50,
    min_points: int = 10,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Bird's-eye occupancy slice of a point/Gaussian cloud.

    Returns (occ bool (H, W) with +y up, extent dict) for points whose
    init_pose-frame z lies in [z_slice +- z_tol]; a cell is occupied when
    >= min_points fall into it (`plot_utils.py:39-88`).
    """
    xyz = np.asarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError("xyz must be (N, 3)")
    init_pose = np.asarray(init_pose, np.float32)
    pts4 = np.concatenate([xyz, np.ones((xyz.shape[0], 1), np.float32)], axis=1)
    cam = (init_pose @ pts4.T).T[:, :3]

    use = (cam[:, 2] >= z_slice - z_tol) & (cam[:, 2] <= z_slice + z_tol)
    if not use.any():
        return (
            np.zeros((1, 1), bool),
            {"xmin": 0.0, "xmax": 0.0, "ymin": 0.0, "ymax": 0.0, "cell": cell},
        )
    flat = cam[use, :2]
    xmin, ymin = flat.min(axis=0)
    xmax, ymax = flat.max(axis=0)
    ix = np.floor((flat[:, 0] - xmin) / cell).astype(np.int64)
    iy = np.floor((flat[:, 1] - ymin) / cell).astype(np.int64)
    w = int((xmax - xmin) // cell) + 1
    h = int((ymax - ymin) // cell) + 1
    counts = np.bincount(iy * w + ix, minlength=h * w).reshape(h, w)
    occ = (counts >= min_points)[::-1]  # +y up
    extent = {
        "xmin": float(xmin), "xmax": float(xmax),
        "ymin": float(ymin), "ymax": float(ymax), "cell": cell,
    }
    return occ, extent


def occupancy_image(
    occ: np.ndarray, free_val: int = 255, occ_val: int = 0, scale: int = 1
) -> np.ndarray:
    """(H, W) bool -> (H*s, W*s, 3) uint8 (white = free, black = occupied) —
    `grid_to_cv2` without the cv2 dependency."""
    img = np.where(occ, occ_val, free_val).astype(np.uint8)
    if scale != 1:
        img = np.kron(img, np.ones((scale, scale), np.uint8))
    return np.repeat(img[:, :, None], 3, axis=2)


def _agg_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _first_dict(item: Any) -> Optional[Dict[str, float]]:
    if isinstance(item, dict):
        return item
    if isinstance(item, (list, tuple)) and item:
        return item[0] if isinstance(item[0], dict) else None
    return None


def plot_pose_gains(
    gains_dict: Dict[str, List[Any]],
    n_per_fig: int = 8,
    max_figs: int = 3,
    save_dir: str = ".",
    prefix: str = "gains",
) -> List[str]:
    """SIL/EIG/mixed gain curves for the longest candidate-pose sequences
    (`plot_utils.py:100-178`). Returns the written figure paths."""
    plt = _agg_plt()
    os.makedirs(save_dir, exist_ok=True)
    poses_sorted = sorted(
        gains_dict.items(), key=lambda kv: len(kv[1]), reverse=True
    )
    poses_top = poses_sorted[: max_figs * n_per_fig]
    if not poses_top:
        return []
    t_max = max(len(seq) for _, seq in poses_top)
    x = np.arange(1, t_max + 1)
    paths = []
    for fig_idx in range(min(math.ceil(len(poses_top) / n_per_fig), max_figs)):
        chunk = poses_top[fig_idx * n_per_fig : (fig_idx + 1) * n_per_fig]
        fig, axes = plt.subplots(3, 1, sharex=True, figsize=(12, 12))
        axes[0].set_title("SIL gains")
        axes[1].set_title("EIG gains")
        axes[2].set_title("Mixed gains")
        axes[2].set_xlabel("Time step")
        for pose_key, seq in chunk:
            sil = np.full(t_max, np.nan)
            eig = np.full(t_max, np.nan)
            mix = np.full(t_max, np.nan)
            for t, item in enumerate(seq):
                rec = _first_dict(item)
                if rec is None:
                    continue
                sil[t] = rec.get("sil", np.nan)
                eig[t] = rec.get("eig", np.nan)
                mix[t] = rec.get("gain", np.nan)
            for ax, ys in zip(axes, (sil, eig, mix)):
                ax.plot(x, ys, marker="o", linestyle="-", label=str(pose_key))
        axes[0].legend(fontsize=7, loc="upper right")
        fig.tight_layout()
        fname = os.path.join(
            save_dir, f"{prefix}_{fig_idx:03d}_{time.time_ns()}.png"
        )
        fig.savefig(fname, dpi=150)
        plt.close(fig)
        paths.append(fname)
    return paths


def plot_value_psnr(
    psnr_arr, value_arr, axis_name: str = "EIG",
    save_dir: str = ".", prefix: str = "psnr_eig",
) -> str:
    """Scatter <value> vs PSNR (`plot_utils.py:181-204`)."""
    plt = _agg_plt()
    os.makedirs(save_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.scatter(psnr_arr, value_arr, alpha=0.8)
    ax.set_xlabel("PSNR")
    ax.set_ylabel(axis_name)
    ax.set_title(f"{axis_name} vs PSNR")
    fig.tight_layout()
    fname = os.path.join(save_dir, f"{prefix}_{time.time_ns()}.pdf")
    fig.savefig(fname, format="pdf", bbox_inches="tight", pad_inches=0.02)
    plt.close(fig)
    return fname


def plot_eig_psnr_slice(
    psnr_arr, eig_arr, sil_arr, thr: float = 100.0,
    axis_name: str = "EIG", save_dir: str = ".", prefix: str = "psnr_eig",
) -> str:
    """Scatter EIG vs PSNR keeping only points with silhouette < thr
    (`plot_utils.py:207-238`)."""
    plt = _agg_plt()
    os.makedirs(save_dir, exist_ok=True)
    psnr_arr = np.asarray(psnr_arr)
    eig_arr = np.asarray(eig_arr)
    mask = np.asarray(sil_arr) < thr
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.scatter(psnr_arr[mask], eig_arr[mask], alpha=0.8)
    ax.set_xlabel("PSNR")
    ax.set_ylabel(axis_name)
    ax.set_title(f"{axis_name} vs PSNR")
    fig.tight_layout()
    fname = os.path.join(save_dir, f"{prefix}_{time.time_ns()}_sliced.pdf")
    fig.savefig(fname, format="pdf", bbox_inches="tight", pad_inches=0.02)
    plt.close(fig)
    return fname


def plot_combined_psnr(
    psnr_values, sil_values, eig_values,
    save_dir: str = ".", prefix: str = "psnr_combined",
) -> str:
    """3-D SIL/EIG/PSNR scatter colour-graded by EIG (`plot_utils.py:241-283`)."""
    plt = _agg_plt()
    from matplotlib.colors import Normalize

    os.makedirs(save_dir, exist_ok=True)
    fig = plt.figure(figsize=(10, 6))
    ax = fig.add_subplot(111, projection="3d")
    norm = Normalize(vmin=float(np.min(eig_values)), vmax=float(np.max(eig_values)))
    sc = ax.scatter(
        psnr_values, sil_values, eig_values, c=eig_values,
        cmap="viridis", norm=norm, alpha=0.85, edgecolors="k", linewidths=0.2,
    )
    ax.set_xlabel("PSNR")
    ax.set_ylabel("SIL")
    ax.set_zlabel("EIG")
    ax.set_title("SIL vs EIG vs PSNR")
    fig.colorbar(sc, ax=ax, pad=0.08).set_label("EIG (colour-mapped)")
    fig.tight_layout()
    fname = os.path.join(save_dir, f"{prefix}_{time.time_ns()}.pdf")
    fig.savefig(fname, format="pdf", bbox_inches="tight", pad_inches=0.02)
    plt.close(fig)
    return fname


def save_running_metrics(
    rows: List[Tuple[float, float, float, float]], out_dir: str
) -> str:
    """Append-style csv of per-frame (sil, eig, psnr, gain) in the
    `running_metrics_*` format `get_monte_plot.get_running_stats` reads."""
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"running_metrics_{time.time_ns()}.csv")
    arr = np.asarray(rows, np.float64).reshape(-1, 4)
    np.savetxt(fname, arr, delimiter=",", header="sil,eig,psnr,gain")
    return fname


def load_running_metrics(exp_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sil, eig, psnr) arrays from an experiment dir's running_metrics csv."""
    fname = sorted(glob.glob(os.path.join(exp_dir, "running_metrics_*")))[0]
    data = np.loadtxt(fname, delimiter=",", skiprows=1).reshape(-1, 4)
    return data[:, 0], data[:, 1], data[:, 2]


def save_tracking_loss_viz(
    render_im: np.ndarray,  # (3, H, W) rendered color
    render_depth: np.ndarray,  # (1, H, W)
    silhouette: np.ndarray,  # (H, W)
    frame_im: np.ndarray,  # (3, H, W) ground truth
    frame_depth: np.ndarray,  # (1, H, W)
    losses: Dict[str, float],
    plot_dir: str,
    iteration: int,
    *,
    use_sil_for_loss: bool = True,
    sil_thres: float = 0.99,
    ignore_outlier_depth_loss: bool = False,
    time_idx: int | None = None,
) -> str:
    """Tracking-loss diagnostic figure (`scripts/splatam.py:299-344`).

    2x4 grid: weighted GT/render RGB + depth, RGB/depth error maps with the
    loss values, the silhouette-presence mask and the combined loss mask —
    the masks are rebuilt here with the same rules the loss used
    (core.losses.slam_loss). Saved as ``tracking_%04d/%04d.png`` when
    ``time_idx`` is given, else ``tmp.png`` (reference keeps only the live
    view); returns the path.
    """
    render_im = np.asarray(render_im, np.float32)
    render_depth = np.asarray(render_depth, np.float32).reshape(
        1, *render_im.shape[1:]
    )
    silhouette = np.asarray(silhouette, np.float32)
    frame_im = np.asarray(frame_im, np.float32)
    frame_depth = np.asarray(frame_depth, np.float32).reshape(render_depth.shape)

    if ignore_outlier_depth_loss:
        depth_error = np.abs(frame_depth - render_depth) * (frame_depth > 0)
        mask = (depth_error < 10 * np.median(depth_error)) & (frame_depth > 0)
    else:
        mask = frame_depth > 0
    presence = silhouette > sil_thres
    if use_sil_for_loss:
        mask = mask & presence[None]
    color_mask = np.broadcast_to(mask, render_im.shape)

    w_render_im = render_im * color_mask
    w_im = frame_im * color_mask
    w_render_depth = render_depth * mask
    w_depth = frame_depth * mask
    diff_rgb = np.abs(w_render_im - w_im).mean(axis=0)
    diff_depth = np.abs(w_render_depth - w_depth).mean(axis=0)

    plt = _agg_plt()
    fig, ax = plt.subplots(2, 4, figsize=(12, 6))
    ax[0, 0].imshow(np.clip(w_im.transpose(1, 2, 0), 0, 1))
    ax[0, 0].set_title("Weighted GT RGB")
    ax[1, 0].imshow(np.clip(w_render_im.transpose(1, 2, 0), 0, 1))
    ax[1, 0].set_title("Weighted Rendered RGB")
    ax[0, 1].imshow(w_depth[0], cmap="jet", vmin=0, vmax=6)
    ax[0, 1].set_title("Weighted GT Depth")
    ax[1, 1].imshow(w_render_depth[0], cmap="jet", vmin=0, vmax=6)
    ax[1, 1].set_title("Weighted Rendered Depth")
    ax[0, 2].imshow(diff_rgb, cmap="jet", vmin=0, vmax=0.8)
    ax[0, 2].set_title(f"Diff RGB, Loss: {round(float(losses.get('im', 0.0)))}")
    ax[1, 2].imshow(diff_depth, cmap="jet", vmin=0, vmax=0.8)
    ax[1, 2].set_title(
        f"Diff Depth, Loss: {round(float(losses.get('depth', 0.0)))}"
    )
    ax[0, 3].imshow(presence, cmap="gray")
    ax[0, 3].set_title("Silhouette Mask")
    ax[1, 3].imshow(mask[0], cmap="gray")
    ax[1, 3].set_title("Loss Mask")
    for i in range(2):
        for j in range(4):
            ax[i, j].axis("off")
    fig.suptitle(f"Tracking Iteration: {iteration}", fontsize=16)
    fig.tight_layout()
    if time_idx is None:
        os.makedirs(plot_dir, exist_ok=True)
        path = os.path.join(plot_dir, "tmp.png")
    else:
        sub = os.path.join(plot_dir, f"tracking_{time_idx:04d}")
        os.makedirs(sub, exist_ok=True)
        path = os.path.join(sub, f"{iteration:04d}.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
