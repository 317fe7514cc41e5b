"""Offline 3D Gaussian Splatting training with ground-truth poses.

Counterpart of ``splatam_tpu/gs/offline.py`` (`scripts/gaussian_splatting.py:
320-616`): per-frame silhouette-driven densification with the poses written
into the trajectory, then a full-map optimization with random-frame
sampling, an exponential means3D LR schedule and Inria clone/split
densification. The renders follow ``RasterConfig(**config["raster"])``,
whose layout is split unless the config says otherwise, so this path runs
the kernels B3a-d.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from splatam_torch.core.losses import calc_ssim, l1_loss_v1, render_for_loss
from splatam_torch.core.optim import AdamState, adam_step, init_adam
from splatam_torch.core.params import (
    GAUSSIAN_KEYS,
    Params,
    Variables,
    get_pose,
    num_gaussians,
    set_pose,
)
from splatam_torch.core.transforms import matrix_to_quaternion
from splatam_torch.device import resolve_device
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import Camera
from splatam_torch.slam.densify import add_new_gaussians
from splatam_torch.slam.initialize import initialize_first_timestep
from splatam_torch.slam.inria_densify import (
    accumulate_mean2d_gradient,
    densify,
    get_expon_lr_func,
)
from splatam_torch.slam.pipeline import SlamState, as_frame


class GsStepResult(NamedTuple):
    losses: Dict[str, torch.Tensor]
    grads: Dict[str, torch.Tensor]  # the gradients the step applied
    seen: torch.Tensor  # (N,) bool
    radius: torch.Tensor  # (N,) int32
    means2d_grad_norm: torch.Tensor  # (N,) screen-space gradient norm


def gs_step(
    params: Params,
    opt_state: AdamState,
    cam_rot: torch.Tensor,
    cam_tran: torch.Tensor,
    frame_im: torch.Tensor,  # (3, H, W)
    frame_depth: torch.Tensor,  # (1, H, W)
    cam: Camera,
    cfg: RasterConfig,
    lrs: Dict[str, float],
    loss_w_im: float = 0.5,
    loss_w_depth: float = 1.0,
) -> GsStepResult:
    """One offline-3DGS Adam iteration on the Gaussians, in place
    (`get_loss_gs`, `gaussian_splatting.py:201-237`): full-image
    0.8 L1 + 0.2 DSSIM on RGB, and L1 of the valid-depth-masked rendered
    depth; the camera stays fixed. The screen means carry a zero offset
    whose gradient norm Inria densification accumulates."""
    gauss = {k: params[k].detach().requires_grad_() for k in GAUSSIAN_KEYS}
    dummy = torch.zeros((gauss["means3D"].shape[0], 2), device=frame_im.device,
                        requires_grad=True)
    out, _ = render_for_loss(
        gauss, cam_rot.detach(), cam_tran.detach(), cam, cfg,
        gaussians_grad=True, camera_grad=False, means2d_dummy=dummy,
    )
    im, depth = out.color[:3], out.color[3:4]
    valid = (frame_depth != 0.0).float()
    losses = {
        "im": 0.8 * l1_loss_v1(im, frame_im)
        + 0.2 * (1.0 - calc_ssim(im, frame_im)),
        "depth": l1_loss_v1(depth * valid, frame_depth),
    }
    loss = loss_w_im * losses["im"] + loss_w_depth * losses["depth"]
    losses["loss"] = loss
    *grads, dummy_grad = torch.autograd.grad(
        loss, [gauss[k] for k in GAUSSIAN_KEYS] + [dummy])
    grads = dict(zip(GAUSSIAN_KEYS, grads))
    adam_step({k: params[k] for k in GAUSSIAN_KEYS}, grads, opt_state, lrs,
              eps=1e-15)
    return GsStepResult(
        losses={k: v.detach() for k, v in losses.items()},
        grads=grads,
        seen=out.radius > 0,
        radius=out.radius,
        means2d_grad_norm=torch.linalg.vector_norm(dummy_grad, dim=-1),
    )


def offline_splatting(
    config: Dict,
    dataset,
    progress: bool = True,
    initial: Optional[Tuple[Params, Variables]] = None,
    use_poses: Optional[np.ndarray] = None,
    device=None,
) -> SlamState:
    """Offline 3DGS training (`offline_splatting`,
    `gaussian_splatting.py:320-616`) over ``dataset`` (a sequence of
    (color, depth, K, c2w)), on ``device`` (None means CUDA; raises when
    CUDA is absent).

    ``initial``/``use_poses`` serve post-SLAM refinement (post_opt.py):
    start from a checkpointed map and use estimated, not ground-truth,
    poses as fixed cameras."""
    dev = resolve_device(device)
    train = config["train"]
    raster_cfg = RasterConfig(**config.get("raster", {}))
    rng = np.random.default_rng(config.get("seed", 0))
    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    distribution = config.get("gaussian_distribution", "isotropic")

    state = SlamState()
    state.layout = raster_cfg.layout
    color, depth, intrinsics, pose = dataset[0]
    params, variables, k3, first_w2c, cam, scene_radius = initialize_first_timestep(
        np.asarray(color), np.asarray(depth), np.asarray(intrinsics),
        np.asarray(pose), num_frames, config["scene_radius_depth_ratio"],
        distribution, device=dev,
    )
    if initial is not None:
        params, variables = initial
    state.cam, state.intrinsics, state.first_w2c = cam, k3, first_w2c
    state.scene_radius = scene_radius

    frames = []
    for time_idx in range(num_frames):
        color, depth, _, pose = dataset[time_idx]
        gt_w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
        state.gt_w2c_all.append(gt_w2c)
        if use_poses is not None:
            gt_w2c = np.asarray(use_poses[time_idx], dtype=np.float64)
        frame_im, frame_depth = as_frame(color, depth, dev)
        frames.append((frame_im, frame_depth))
        # the (ground-truth or estimated) pose goes into the trajectory
        rel = torch.as_tensor(gt_w2c, dtype=torch.float32, device=dev)
        rot, tran = matrix_to_quaternion(rel[:3, :3]), rel[:3, 3]
        set_pose(params, time_idx, rot, tran)
        if time_idx > 0 and initial is None:
            params, variables, _ = add_new_gaussians(
                params, variables, frame_im, frame_depth, k3, cam, raster_cfg,
                train["sil_thres"], time_idx, distribution, pose=(rot, tran),
            )
            state.counts["densify_renders"] += 1
        if progress and time_idx % 50 == 0:
            print(f"init frame {time_idx}/{num_frames} "
                  f"gaussians={num_gaussians(params)}")

    # ---- full-map optimization ----
    num_iters = train["num_iters_mapping"]
    lrs = dict(train["lrs_mapping"])
    sched = get_expon_lr_func(
        lr_init=lrs["means3D"],
        lr_final=train.get("lrs_mapping_means3D_final", lrs["means3D"]),
        lr_delay_mult=train.get("lr_delay_mult", 1.0),
        max_steps=num_iters,
    )
    opt_state = init_adam({k: params[k] for k in GAUSSIAN_KEYS})
    use_densify = train.get("use_gaussian_splatting_densification", False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for it in range(num_iters):
        step_lrs = {k: lrs[k] for k in GAUSSIAN_KEYS}
        step_lrs["means3D"] = float(sched(it + 1))
        t_idx = int(rng.integers(0, num_frames))
        frame_im, frame_depth = frames[t_idx]
        rot_t, tran_t = get_pose(params, t_idx)
        res = gs_step(
            params, opt_state, rot_t, tran_t, frame_im, frame_depth, cam,
            raster_cfg, step_lrs,
            loss_w_im=train["loss_weights"]["im"],
            loss_w_depth=train["loss_weights"]["depth"],
        )
        mr = variables["max_2D_radius"]
        variables["max_2D_radius"] = torch.where(
            res.seen, torch.maximum(res.radius.float(), mr), mr)
        if use_densify:
            variables = accumulate_mean2d_gradient(
                variables, res.means2d_grad_norm, res.seen)
            params, variables, opt_state = densify(
                params, variables, opt_state, it, train["densify_dict"],
                state.scene_radius, rng,
            )
        if progress and (it % 100 == 0 or it == num_iters - 1):
            print(f"iter {it}/{num_iters} "
                  f"loss={float(res.losses['loss']):.4f} "
                  f"gaussians={num_gaussians(params)} "
                  f"({time.time() - t0:.1f}s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    state.counts["offline_iters"] = num_iters
    state.timing["offline_iter"] = [(time.time() - t0) / max(num_iters, 1)]
    state.params = params
    state.variables = variables
    return state
