"""Trigger-driven realtime SLAM driver.

Counterpart of ``splatam_tpu/realtime/driver.py``
(`scripts/splatam_realtime.py:676-1014`): frames arrive from a FrameSource
(the ROS bridge, a replayed dump) instead of a dataset index; between
frames it serves active-view-selection gain requests; every frame
is tracked, densified and mapped, then the visited-pose list grows and
H_train_inv is recomputed.

As in the JAX driver, the raster layout is the config's as it stands (no
frame-0 resolution): tracking, densification and mapping render in it,
while the Fisher path (H_train recomputes and gains) bins aligned and runs
B1 + B4. Tracking and mapping bin afresh every iteration, as the JAX
driver does.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose, num_gaussians, set_pose
from splatam_torch.core.transforms import matrix_to_quaternion, pose_to_w2c
from splatam_torch.device import resolve_device
from splatam_torch.realtime.handler import ActiveViewHandler, GainConfig
from splatam_torch.render.binning import RasterConfig
from splatam_torch.slam.densify import add_new_gaussians
from splatam_torch.slam.initialize import initialize_first_timestep
from splatam_torch.slam.keyframes import keyframe_selection_overlap
from splatam_torch.slam.mapping import init_mapping_optimizer, map_step, prune_gaussians
from splatam_torch.slam.pipeline import SlamState, _sync, as_frame
from splatam_torch.slam.tracking import initialize_camera_pose, track_frame


class FrameSource:
    """Frame/trigger protocol the realtime driver consumes.

    Implementations: ros_bridge.RosFrameSource (live), ReplaySource
    (a dataset or a dumped stream, replayed)."""

    def finished(self) -> bool:
        raise NotImplementedError

    def next_frame(self, timeout: float = 0.01):
        """Return (color, depth, intrinsics, c2w pose) or None if no trigger."""
        raise NotImplementedError

    def pending_gain_request(self) -> Optional[Sequence[np.ndarray]]:
        """Candidate pose vectors awaiting gains, or None."""
        return None

    def publish_gains(self, gains: List[Dict[str, float]]) -> None:
        pass


class ReplaySource(FrameSource):
    """Replays a dataset as an always-triggered stream. ``gain_requests``
    maps a frame index to the candidates requested just before it."""

    def __init__(self, dataset, gain_requests: Optional[Dict[int, Sequence]] = None):
        self.dataset = dataset
        self.idx = 0
        self.gain_requests = gain_requests or {}
        self.published: List[List[Dict[str, float]]] = []

    def finished(self) -> bool:
        return self.idx >= len(self.dataset)

    def next_frame(self, timeout: float = 0.01):
        item = self.dataset[self.idx]
        self.idx += 1
        return item

    def pending_gain_request(self):
        return self.gain_requests.pop(self.idx, None)

    def publish_gains(self, gains):
        self.published.append(gains)


def realtime_slam(
    config: Dict,
    source: FrameSource,
    gain_cfg: GainConfig = GainConfig(),
    progress: bool = True,
    device=None,
) -> Tuple[SlamState, ActiveViewHandler]:
    """Run SplaTAM on a live frame stream with gain serving, on ``device``
    (None means CUDA; raises when CUDA is absent)."""
    dev = resolve_device(device)
    cfg_track = config["tracking"]
    cfg_map = config["mapping"]
    raster_cfg = RasterConfig(**config.get("raster", {}))
    rng = np.random.default_rng(config.get("seed", 0))

    state = SlamState()
    state.layout = raster_cfg.layout
    handler: Optional[ActiveViewHandler] = None
    params = variables = None
    time_idx = -1
    gauss_lrs = {k: v for k, v in cfg_map["lrs"].items() if k in GAUSSIAN_KEYS}
    dist = config.get("gaussian_distribution", "isotropic")

    while not source.finished():
        # serve gain requests while idle (`splatam_realtime.py:690`)
        req = source.pending_gain_request()
        if req is not None and handler is not None and params is not None:
            source.publish_gains(handler.compute_gains(params, None, req))

        item = source.next_frame()
        if item is None:
            time.sleep(0.005)
            continue
        color, depth, intrinsics, pose = item
        time_idx += 1
        t_frame = time.perf_counter()
        gt_w2c = np.linalg.inv(np.asarray(pose, dtype=np.float64))
        state.gt_w2c_all.append(gt_w2c)
        frame_im, frame_depth = as_frame(color, depth, dev)

        if time_idx == 0:
            params, variables, k3, first_w2c, cam, scene_radius = (
                initialize_first_timestep(
                    np.asarray(color), np.asarray(depth), np.asarray(intrinsics),
                    np.asarray(pose), config["data"].get("max_frames", 4096),
                    config["scene_radius_depth_ratio"], dist, device=dev,
                )
            )
            state.cam, state.intrinsics, state.first_w2c = cam, k3, first_w2c
            state.scene_radius = scene_radius
            handler = ActiveViewHandler(
                cam, raster_cfg, gain_cfg,
                initial_pose=np.asarray(pose, dtype=np.float64), rng=rng,
            )
        elif cfg_track["use_gt_poses"]:
            rel = torch.as_tensor(gt_w2c, dtype=torch.float32, device=dev)
            set_pose(params, time_idx, matrix_to_quaternion(rel[:3, :3]),
                     rel[:3, 3])
        else:
            rot0, tran0 = initialize_camera_pose(
                params, time_idx, cfg_track["forward_prop"])
            res = track_frame(
                {k: params[k] for k in GAUSSIAN_KEYS}, rot0, tran0,
                frame_im, frame_depth, state.cam, raster_cfg,
                num_iters=cfg_track["num_iters"],
                use_sil_for_loss=cfg_track["use_sil_for_loss"],
                sil_thres=cfg_track["sil_thres"],
                ignore_outlier_depth_loss=cfg_track["ignore_outlier_depth_loss"],
                loss_w_im=cfg_track["loss_weights"]["im"],
                loss_w_depth=cfg_track["loss_weights"]["depth"],
                lr_rot=cfg_track["lrs"]["cam_unnorm_rots"],
                lr_tran=cfg_track["lrs"]["cam_trans"],
                rebin_every=0,
            )
            set_pose(params, time_idx, res.best_rot, res.best_tran)
            state.counts["tracking_iters"] += cfg_track["num_iters"]

        # densify + map every frame (realtime maps per trigger)
        if cfg_map["add_new_gaussians"] and time_idx > 0:
            params, variables, _ = add_new_gaussians(
                params, variables, frame_im, frame_depth, state.intrinsics,
                state.cam, raster_cfg, cfg_map["sil_thres"], time_idx, dist,
                pose=get_pose(params, time_idx),
            )
            state.counts["densify_renders"] += 1
        curr_w2c = pose_to_w2c(*get_pose(params, time_idx)).cpu().numpy()
        selected = keyframe_selection_overlap(
            frame_depth.cpu().numpy(), curr_w2c, state.intrinsics,
            state.keyframe_list[:-1], config["mapping_window_size"] - 2, rng=rng,
        )
        selected_frames = [state.keyframe_list[i] for i in selected]
        if state.keyframe_list:
            selected_frames.append(state.keyframe_list[-1])
        selected_frames.append(
            {"id": time_idx, "est_w2c": curr_w2c, "im": frame_im,
             "depth": frame_depth}
        )
        opt_state = init_mapping_optimizer(params)
        for it in range(cfg_map["num_iters"]):
            kf = selected_frames[rng.integers(0, len(selected_frames))]
            kf_rot, kf_tran = get_pose(params, kf["id"])
            map_step(
                params, opt_state, kf_rot, kf_tran, kf["im"], kf["depth"],
                state.cam, raster_cfg, lrs=gauss_lrs,
                sil_thres=cfg_map["sil_thres"],
                use_sil_for_loss=cfg_map["use_sil_for_loss"],
                ignore_outlier_depth_loss=cfg_map["ignore_outlier_depth_loss"],
                loss_w_im=cfg_map["loss_weights"]["im"],
                loss_w_depth=cfg_map["loss_weights"]["depth"],
            )
            if cfg_map.get("prune_gaussians", False):
                params, variables, _ = prune_gaussians(
                    params, variables, opt_state, it,
                    cfg_map["pruning_dict"], state.scene_radius,
                )
        state.counts["mapping_iters"] += cfg_map["num_iters"]

        # keyframe bookkeeping
        if (
            time_idx == 0
            or (time_idx + 1) % config["keyframe_every"] == 0
        ) and np.isfinite(gt_w2c).all():
            state.keyframe_list.append(
                {"id": time_idx, "est_w2c": curr_w2c, "im": frame_im,
                 "depth": frame_depth}
            )
            state.keyframe_time_indices.append(time_idx)

        # Fisher bookkeeping (`splatam_realtime.py:1010-1011`)
        handler.add_visited_pose(np.linalg.inv(curr_w2c))
        if gain_cfg.k_eig != 0:
            handler.recompute_h_train_inv(params, None)
        _sync(dev)
        state.timing["frame"].append(time.perf_counter() - t_frame)

        if progress:
            print(f"rt frame {time_idx} gaussians={num_gaussians(params)}")

    state.params = params
    state.variables = variables
    return state, handler
