"""The SplaTAM SLAM loop: interleaved tracking, densification, mapping.

Counterpart of ``splatam_tpu/slam/pipeline.py`` (`rgbd_slam`,
`scripts/splatam.py:461-1010`) and of its config schema, so the same config
dicts run in both: separate tracking and densification resolutions, the
depth-loss-threshold doubling of the tracking iterations, ``fixed_binning``,
``report_global_progress_every``, checkpoint resume and the periodic save,
``frame_callback``, wandb logging (``use_wandb``, where wandb imports),
bundle adjustment in mapping (``mapping.do_ba``), Inria densification
inside mapping (``mapping.use_gaussian_splatting_densification``) and the
tracking-loss figures (``tracking.visualize_tracking_loss``). A config
whose ``raster`` does not set ``layout`` gets it from frame 0's instance
density (``resolve_auto_layout``), as in JAX. ``map_capacity`` (the JAX
package's pre-sized map capacity) is accepted and ignored: the port's map
grows.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from splatam_torch.core.losses import (
    compute_binned,
    count_instances,
    render_for_loss,
    slam_loss,
)
from splatam_torch.core.params import (
    GAUSSIAN_KEYS,
    Params,
    Variables,
    get_pose,
    num_gaussians,
    set_pose,
)
from splatam_torch.core.transforms import matrix_to_quaternion, pose_to_w2c
from splatam_torch.device import resolve_device
from splatam_torch.eval.report import report_progress
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.geometry import grid_dims
from splatam_torch.slam.densify import add_new_gaussians
from splatam_torch.slam.initialize import initialize_first_timestep
from splatam_torch.slam.inria_densify import accumulate_mean2d_gradient, densify
from splatam_torch.slam.keyframes import keyframe_selection_overlap
from splatam_torch.slam.mapping import (
    init_mapping_optimizer,
    map_step,
    prune_gaussians,
)
from splatam_torch.slam.tracking import initialize_camera_pose, track_frame
from splatam_torch.utils.checkpoint import load_params, save_params_ckpt
from splatam_torch.viz.plots import save_tracking_loss_viz


def as_frame(color, depth, device):
    """(H,W,3) [0..255], (H,W,1) -> (3,H,W) [0..1], (1,H,W) on device."""
    im = torch.as_tensor(
        (np.transpose(np.asarray(color), (2, 0, 1)) / 255.0).astype(np.float32),
        device=device,
    )
    d = torch.as_tensor(
        np.transpose(np.asarray(depth), (2, 0, 1)).astype(np.float32),
        device=device,
    )
    return im, d


def resolve_auto_layout(total_instances: int, num_tiles: int,
                        chunk: int) -> str:
    """Density-adaptive stream layout (``splatam_tpu/slam/pipeline.py``):
    split below 2 chunks of instances per tile, aligned above."""
    dens = total_instances / max(num_tiles, 1)
    return "split" if dens < 2 * chunk else "aligned"


class SlamState:
    """Host-side SLAM state: map, keyframes, trajectory and telemetry."""

    def __init__(self):
        self.params: Params = {}
        self.variables: Variables = {}
        self.keyframe_list: List[Dict] = []
        self.keyframe_time_indices: List[int] = []
        self.gt_w2c_all: List[np.ndarray] = []
        self.cam = None
        self.intrinsics = None
        self.first_w2c = None
        self.scene_radius = 0.0
        self.timing = {
            "tracking_iter": [], "tracking_frame": [],
            "mapping_iter": [], "mapping_frame": [],
            "frame": [],  # whole frames (the realtime driver)
        }
        # iterations run and renders made, for launch accounting; each
        # tracking figure renders twice (its loss and its images);
        # gs_densified: Inria densification steps that grew the map
        self.counts = {"tracking_iters": 0, "mapping_iters": 0,
                       "densify_renders": 0, "progress_renders": 0,
                       "tracking_doubled": 0, "tracking_figures": 0,
                       "gs_densified": 0}
        self.nonfinite = {"tracking": 0, "mapping": 0}
        self.layout = None  # the raster layout the run used
        self.log_fn = None  # wandb's run.log with use_wandb


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _camera_of(ds, first_w2c, dev):
    """The camera, and its intrinsics, of ``ds``'s frames at first_w2c."""
    color, _, k4, _ = ds[0]
    k3 = np.asarray(k4)[:3, :3]
    cam = setup_camera(np.asarray(color).shape[1], np.asarray(color).shape[0],
                       k3, first_w2c, device=dev)
    return cam, k3


def _resume(config, dataset, state, dev):
    """Load the checkpoint ``config`` names and rebuild the frames before it:
    their ground-truth poses and keyframes (`scripts/splatam.py:624-658`).
    Returns (params, variables, the frame to start at)."""
    ckpt_idx = config["checkpoint_time_idx"]
    ckpt_dir = os.path.join(config["workdir"], config["run_name"])
    params, variables, _ = load_params(
        os.path.join(ckpt_dir, f"params{ckpt_idx}.npz"), device=dev)
    kf_inds = np.load(
        os.path.join(ckpt_dir, f"keyframe_time_indices{ckpt_idx}.npy"))
    for t in range(ckpt_idx):
        color, depth, _, pose = dataset[t]
        state.gt_w2c_all.append(np.linalg.inv(np.asarray(pose, dtype=np.float64)))
        if t in kf_inds:
            frame_im, frame_depth = as_frame(color, depth, dev)
            curr_w2c = pose_to_w2c(*get_pose(params, t)).cpu().numpy()
            state.keyframe_list.append(
                {"id": t, "est_w2c": curr_w2c, "im": frame_im,
                 "depth": frame_depth})
            state.keyframe_time_indices.append(t)
    return params, variables, ckpt_idx


def rgbd_slam(config: Dict, dataset, tracking_dataset=None,
              densify_dataset=None, progress: bool = True,
              frame_callback=None, device=None) -> SlamState:
    """Run SplaTAM over ``dataset`` (sequence of (color, depth, K, c2w)).

    ``tracking_dataset`` / ``densify_dataset`` optionally give the same
    sequence at other resolutions (SplaTAM-S tracks at full and densifies
    at half resolution, `scripts/splatam.py:504-607`).
    ``frame_callback(time_idx, state)`` runs before each frame. Runs on
    ``device`` (None means CUDA; raises when CUDA is absent)."""
    dev = resolve_device(device)
    cfg_track = config["tracking"]
    cfg_map = config["mapping"]
    raster_cfg = RasterConfig(**config.get("raster", {}))
    rng = np.random.default_rng(config.get("seed", 0))
    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    state = SlamState()
    if config.get("use_wandb", False):
        try:
            import wandb
        except ImportError:
            print("[warn] use_wandb=True but wandb is not installed; skipping")
        else:
            state.log_fn = wandb.init(**config.get("wandb", {})).log

    color, depth, intrinsics, pose = dataset[0]
    params, variables, k3, first_w2c, cam, scene_radius = initialize_first_timestep(
        np.asarray(color), np.asarray(depth), np.asarray(intrinsics),
        np.asarray(pose), num_frames, config["scene_radius_depth_ratio"],
        config.get("gaussian_distribution", "isotropic"),
        config.get("mean_sq_dist_method", "projective"), device=dev,
    )
    state.cam, state.intrinsics, state.first_w2c = cam, k3, first_w2c
    state.scene_radius = scene_radius
    if "layout" not in config.get("raster", {}):
        # JAX resolves it once per run from frame 0's (gaussian, tile) pairs
        total0 = count_instances(
            params, torch.tensor([1.0, 0, 0, 0], device=dev),
            torch.zeros(3, device=dev), cam,
        )
        gx, gy = grid_dims(cam)
        raster_cfg = dataclasses.replace(raster_cfg, layout=resolve_auto_layout(
            total0, gx * gy, raster_cfg.chunk))
        if progress:
            print(f"[info] auto layout: {raster_cfg.layout} ({total0} "
                  f"instances, {total0 / (gx * gy):.0f}/tile at frame 0)")
    state.layout = raster_cfg.layout
    # separate-resolution cameras (`scripts/splatam.py:557-607`)
    track_cam, densify_cam, densify_k3 = cam, cam, k3
    if tracking_dataset is not None:
        track_cam, _ = _camera_of(tracking_dataset, first_w2c, dev)
    if densify_dataset is not None:
        densify_cam, densify_k3 = _camera_of(densify_dataset, first_w2c, dev)
    # bundle adjustment (`scripts/splatam.py:232-238`): mapping also steps
    # the sampled keyframe's pose, with the mapping lrs' cam_* rates
    do_ba = bool(cfg_map.get("do_ba", False))
    use_gs_densify = cfg_map.get("use_gaussian_splatting_densification", False)
    viz_track = cfg_track.get("visualize_tracking_loss", False)
    plot_dir = os.path.join(config.get("workdir", "."), "plots")
    nonfinite_track = torch.zeros((), dtype=torch.int32, device=dev)
    nonfinite_map = torch.zeros((), dtype=torch.int32, device=dev)
    fixed_binning = cfg_track.get("fixed_binning", False)
    progress_every = config.get("report_global_progress_every", 0)

    start_frame = 0
    if config.get("load_checkpoint", False):
        params, variables, start_frame = _resume(config, dataset, state, dev)

    for time_idx in range(start_frame, num_frames):
        if frame_callback is not None:
            frame_callback(time_idx, state)
        color, depth, _, pose = dataset[time_idx]
        gt_w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
        state.gt_w2c_all.append(gt_w2c)
        frame_im, frame_depth = as_frame(color, depth, dev)
        if tracking_dataset is not None:
            tc, td, _, _ = tracking_dataset[time_idx]
            track_im, track_depth = as_frame(tc, td, dev)
        else:
            track_im, track_depth = frame_im, frame_depth

        # --- tracking ---
        t0 = time.time()
        if time_idx > 0:
            if cfg_track["use_gt_poses"]:
                rel = torch.as_tensor(gt_w2c, dtype=torch.float32, device=dev)
                set_pose(params, time_idx, matrix_to_quaternion(rel[:3, :3]),
                         rel[:3, 3])
            else:
                rot0, tran0 = initialize_camera_pose(
                    params, time_idx, cfg_track["forward_prop"]
                )
                n_iters = cfg_track["num_iters"]
                gauss = {k: params[k] for k in GAUSSIAN_KEYS}

                @torch.no_grad()
                def draw(done, rot, tran):
                    """The tracking-loss figure at the pose after ``done``
                    iterations (`scripts/splatam.py:299-344`)."""
                    out = slam_loss(
                        gauss, rot, tran, track_im, track_depth, track_cam,
                        raster_cfg, tracking=True,
                        loss_w_im=cfg_track["loss_weights"]["im"],
                        loss_w_depth=cfg_track["loss_weights"]["depth"],
                        use_sil_for_loss=cfg_track["use_sil_for_loss"],
                        sil_thres=cfg_track["sil_thres"],
                        ignore_outlier_depth_loss=cfg_track["ignore_outlier_depth_loss"],
                    )
                    img = render_for_loss(
                        gauss, rot, tran, track_cam, raster_cfg,
                        gaussians_grad=False, camera_grad=False)[0].color
                    save_tracking_loss_viz(
                        img[:3].cpu().numpy(), img[3:4].cpu().numpy(),
                        img[4].cpu().numpy(), track_im.cpu().numpy(),
                        track_depth.cpu().numpy(),
                        {k: float(v) for k, v in out.losses.items()},
                        plot_dir, done,
                        use_sil_for_loss=cfg_track["use_sil_for_loss"],
                        sil_thres=cfg_track["sil_thres"],
                        ignore_outlier_depth_loss=cfg_track["ignore_outlier_depth_loss"],
                        time_idx=time_idx,
                    )
                    state.counts["tracking_figures"] += 1

                def run_track(resume=None):
                    return track_frame(
                        gauss, rot0, tran0, track_im, track_depth, track_cam,
                        raster_cfg, num_iters=n_iters,
                        use_sil_for_loss=cfg_track["use_sil_for_loss"],
                        sil_thres=cfg_track["sil_thres"],
                        ignore_outlier_depth_loss=cfg_track["ignore_outlier_depth_loss"],
                        loss_w_im=cfg_track["loss_weights"]["im"],
                        loss_w_depth=cfg_track["loss_weights"]["depth"],
                        lr_rot=cfg_track["lrs"]["cam_unnorm_rots"],
                        lr_tran=cfg_track["lrs"]["cam_trans"],
                        rebin_every=cfg_track.get("rebin_every", 10),
                        fixed_binning=fixed_binning, resume=resume,
                        on_segment=draw if viz_track else None,
                    )

                res = run_track()
                iters_run = n_iters
                if (
                    cfg_track.get("use_depth_loss_thres", False)
                    and float(res.last_losses["depth"])
                    >= cfg_track.get("depth_loss_thres", 1e9)
                ):
                    # double the iterations once by CONTINUING the same Adam
                    # run: pose, moments and best candidate carry over
                    # (`scripts/splatam.py:745-758`, do_continue_slam)
                    nonfinite_track = nonfinite_track + res.nonfinite
                    res = run_track(resume=res.resume_state)
                    iters_run += n_iters
                    state.counts["tracking_doubled"] += 1
                set_pose(params, time_idx, res.best_rot, res.best_tran)
                nonfinite_track = nonfinite_track + res.nonfinite
                state.counts["tracking_iters"] += iters_run
                _sync(dev)
                state.timing["tracking_iter"].append(
                    (time.time() - t0) / max(iters_run, 1)
                )
        state.timing["tracking_frame"].append(time.time() - t0)

        # --- global progress telemetry (`utils/eval_helpers.py:152-276`) ---
        if progress_every and ((time_idx + 1) % progress_every == 0
                               or time_idx == num_frames - 1):
            stats = report_progress(
                params, frame_im, frame_depth, cam, raster_cfg, time_idx,
                cfg_track["sil_thres"], tracking=True,
                gt_w2c_list=state.gt_w2c_all, first_w2c=state.first_w2c,
                log_fn=state.log_fn,
            )
            state.counts["progress_renders"] += 1
            if progress:
                print(f"  progress@{time_idx}: psnr={stats['psnr']:.2f} "
                      f"ate={stats.get('ate', float('nan')) * 100:.2f}cm")

        # --- densification + mapping ---
        if time_idx == 0 or (time_idx + 1) % config["map_every"] == 0:
            if cfg_map["add_new_gaussians"] and time_idx > 0:
                if densify_dataset is not None:
                    dc, dd, _, _ = densify_dataset[time_idx]
                    dens_im, dens_depth = as_frame(dc, dd, dev)
                else:
                    dens_im, dens_depth = frame_im, frame_depth
                params, variables, _ = add_new_gaussians(
                    params, variables, dens_im, dens_depth, densify_k3,
                    densify_cam, raster_cfg, cfg_map["sil_thres"], time_idx,
                    config.get("gaussian_distribution", "isotropic"),
                    pose=get_pose(params, time_idx),
                )
                state.counts["densify_renders"] += 1

            curr_w2c = pose_to_w2c(*get_pose(params, time_idx)).cpu().numpy()
            selected = keyframe_selection_overlap(
                frame_depth.cpu().numpy(), curr_w2c, state.intrinsics,
                state.keyframe_list[:-1], config["mapping_window_size"] - 2,
                rng=rng,
            )
            selected_frames = [state.keyframe_list[i] for i in selected]
            if state.keyframe_list:
                selected_frames.append(state.keyframe_list[-1])
            selected_frames.append(
                {"id": time_idx, "est_w2c": curr_w2c, "im": frame_im,
                 "depth": frame_depth}
            )

            t1 = time.time()
            map_rebin = cfg_map.get("rebin_every", 10)
            opt_state = init_mapping_optimizer(params)
            # keyframe id -> [binning, iteration it was made, latest sat depth]
            binned_cache: Dict[int, list] = {}
            # one pose Adam state per keyframe and phase (the reference
            # builds one optimizer over the whole trajectory per phase, and
            # a step touches only the sampled keyframe's pose)
            pose_opts: Dict[int, object] = {}
            for it in range(cfg_map["num_iters"]):
                kf = selected_frames[rng.integers(0, len(selected_frames))]
                kf_rot, kf_tran = get_pose(params, kf["id"])
                cached = None
                if map_rebin:
                    cached = binned_cache.get(kf["id"])
                    if cached is None or it - cached[1] >= map_rebin:
                        cap = None if cached is None else cached[2]
                        cached = [
                            compute_binned(params, kf_rot, kf_tran, cam,
                                           raster_cfg, depth_cap=cap),
                            it, None,
                        ]
                        binned_cache[kf["id"]] = cached
                result = map_step(
                    params, opt_state, kf_rot, kf_tran, kf["im"], kf["depth"],
                    cam, raster_cfg, lrs=cfg_map["lrs"],
                    sil_thres=cfg_map["sil_thres"],
                    use_sil_for_loss=cfg_map["use_sil_for_loss"],
                    ignore_outlier_depth_loss=cfg_map["ignore_outlier_depth_loss"],
                    loss_w_im=cfg_map["loss_weights"]["im"],
                    loss_w_depth=cfg_map["loss_weights"]["depth"],
                    track_means2d_grad=use_gs_densify, do_ba=do_ba,
                    pose_opt=pose_opts.get(kf["id"]),
                    binned=None if cached is None else cached[0],
                )
                if cached is not None:
                    cached[2] = result.sat_depth
                nonfinite_map = nonfinite_map + result.nonfinite.int()
                if do_ba:
                    set_pose(params, kf["id"], result.cam_rot, result.cam_tran)
                    pose_opts[kf["id"]] = result.pose_opt
                    # the pose moved: this keyframe's frozen binning is stale
                    binned_cache.pop(kf["id"], None)
                mr = variables["max_2D_radius"]
                variables["max_2D_radius"] = torch.where(
                    result.seen, torch.maximum(result.radius.float(), mr), mr
                )
                # before pruning, which takes rows away (the JAX package
                # clears active bits and accumulates after it)
                if use_gs_densify and it <= cfg_map["densify_dict"]["stop_after"]:
                    variables = accumulate_mean2d_gradient(
                        variables, result.means2d_grad_norm, result.seen)
                if cfg_map.get("prune_gaussians", False):
                    params, variables, changed = prune_gaussians(
                        params, variables, opt_state, it,
                        cfg_map["pruning_dict"], state.scene_radius,
                    )
                    if changed:
                        binned_cache.clear()
                # Inria densification inside mapping (`scripts/splatam.py:
                # 883-885`): after the step, as in the JAX package; the new
                # Gaussians start optimizing at the next iteration
                if use_gs_densify:
                    n0 = num_gaussians(params)
                    params, variables, opt_state = densify(
                        params, variables, opt_state, it,
                        cfg_map["densify_dict"], state.scene_radius, rng,
                    )
                    state.counts["gs_densified"] += num_gaussians(params) > n0
                    binned_cache.clear()
            state.counts["mapping_iters"] += cfg_map["num_iters"]
            _sync(dev)
            if cfg_map["num_iters"] > 0:
                state.timing["mapping_iter"].append(
                    (time.time() - t1) / cfg_map["num_iters"]
                )
            state.timing["mapping_frame"].append(time.time() - t1)

        # --- keyframe bookkeeping ---
        if (
            time_idx == 0
            or (time_idx + 1) % config["keyframe_every"] == 0
            or time_idx == num_frames - 2
        ) and np.isfinite(gt_w2c).all():
            curr_w2c = pose_to_w2c(*get_pose(params, time_idx)).cpu().numpy()
            state.keyframe_list.append(
                {"id": time_idx, "est_w2c": curr_w2c, "im": frame_im,
                 "depth": frame_depth}
            )
            state.keyframe_time_indices.append(time_idx)

        # --- periodic checkpoint (`scripts/splatam.py:947-951`) ---
        if (
            config.get("save_checkpoints", False)
            and time_idx % config.get("checkpoint_interval", 100) == 0
            and time_idx > 0
        ):
            ckpt_dir = os.path.join(config["workdir"], config["run_name"])
            save_params_ckpt(params, variables, ckpt_dir, time_idx)
            np.save(
                os.path.join(ckpt_dir, f"keyframe_time_indices{time_idx}.npy"),
                np.array(state.keyframe_time_indices),
            )

        if progress and (time_idx % 10 == 0 or time_idx == num_frames - 1):
            print(f"frame {time_idx}/{num_frames}  "
                  f"gaussians={num_gaussians(params)}")

    state.params = params
    state.variables = variables
    state.nonfinite = {"tracking": int(nonfinite_track),
                       "mapping": int(nonfinite_map)}
    if any(state.nonfinite.values()):
        print("[warn] skipped NaN/inf-loss iterations: "
              f"tracking={state.nonfinite['tracking']} "
              f"mapping={state.nonfinite['mapping']}")
    return state
