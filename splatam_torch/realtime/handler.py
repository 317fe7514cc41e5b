"""Active-view-selection handler: per-candidate silhouette + Fisher gains.

Counterpart of ``splatam_tpu/realtime/handler.py``, the IO-agnostic core of
the reference fork's ``RosHandler`` (`scripts/ros_handler.py:32-986`);
the ROS pub/sub lives in ros_bridge.py. An external planner proposes
candidate poses; the handler scores each with

  g_sil = #(silhouette < 0.5) / (W*H) * k_sil       (`ros_handler.py:299-311`)
  g_eig = sum(H_pose * H_train_inv) * k_eig          (`ros_handler.py:832-836`)
  g_sum = k_sum * (g_eig + g_sil)                    with optional sigmoid
                                                     squashing of either term

where H_pose is the diagonal Fisher [means3D || opacity] (fisher/, kernel
B4) and H_train_inv = 1 / (sum of H over <= 40 Monte-Carlo-sampled visited
poses + 0.1) (`ros_handler.py:807-829`).

The map here holds exactly its live gaussians, in rows that prunes compact
and appends extend at the end. ``h_train_inv`` has the rows of the map at
its last recompute; a gain request lines it up with the current rows:
rows appended since then have no Fisher yet and get 1 / eps, as the JAX
package's zero-Fisher slots do.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatam_torch.core.losses import render_for_loss
from splatam_torch.core.params import GAUSSIAN_KEYS
from splatam_torch.fisher import fisher_gains_batch, fisher_h_train, render_fisher
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import Camera
from splatam_torch.slam.pipeline import _sync


def _w2c_rt(w2c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """w2c 4x4 -> (quaternion wxyz, translation), on the host. Any unit
    quaternion sign is equivalent downstream."""
    from scipy.spatial.transform import Rotation

    q_xyzw = Rotation.from_matrix(np.asarray(w2c[:3, :3], np.float64)).as_quat()
    rot = np.roll(q_xyzw, 1).astype(np.float32)  # -> (w, x, y, z)
    return rot, np.asarray(w2c[:3, 3], np.float32)


def pose_matrix_from_quaternion(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 c2w (`ros_handler.py:372-380`)."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
    pose[:3, 3] = pvec[:3]
    return pose


def relative_transformation(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """Pose of t2 in t1's frame (`geometryutils.py:413-`)."""
    return np.linalg.inv(t1) @ t2


def associate_timestamps(
    t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.08
) -> List[Tuple[int, int]]:
    """Nearest-timestamp association (`ros_handler.py:362-370`)."""
    pairs = []
    for i, t in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - t)))
        if abs(t_b[j] - t) < max_dt:
            pairs.append((i, j))
    return pairs


@dataclasses.dataclass
class GainConfig:
    """The realtime CLI's gain flags (`splatam_realtime.py:1117-1143`)."""

    k_sil: float = 1.0
    k_eig: float = 0.0
    k_sum: float = 1.0
    nl_sil: bool = False  # sigmoid-squash silhouette gain
    nl_eig: bool = False  # sigmoid-squash EIG gain
    monte_carlo: Optional[int] = 40  # visited-pose subsample for H_train
    fisher_seed: float = 1e-3
    h_train_eps: float = 0.1


def _nonlinear(x: float) -> float:
    return (3400.0 / (1.0 + math.exp(-0.002 * x))) - 1700.0


class ActiveViewHandler:
    """Holds the visited-pose Fisher state and scores candidate poses.

    ``active`` arguments are (N,) bool masks over the map's rows, or None
    for every row (the port's maps hold only live gaussians)."""

    def __init__(
        self,
        cam: Camera,
        raster_cfg: RasterConfig,
        gain_cfg: GainConfig = GainConfig(),
        initial_pose: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.cam = cam
        self.raster_cfg = raster_cfg
        self.cfg = gain_cfg
        self.initial_pose = initial_pose  # world frame of the planner
        self.visited_poses: List[np.ndarray] = []  # c2w, SLAM frame
        self.h_train_inv: Optional[np.ndarray] = None  # (N at recompute, 4)
        self._h_train_inv_dev: Optional[torch.Tensor] = None
        self.rng = rng or np.random.default_rng(0)
        # time spent in h_train recomputes and gain requests (s), and the
        # poses each rendered, for the realtime measurements
        self.timing = {"h_train": [], "gains": []}
        self.counts = {"h_train_poses": 0, "gain_candidates": 0}

    @staticmethod
    def _gauss(params: Dict) -> Dict:
        return {k: params[k] for k in GAUSSIAN_KEYS}

    def _pose(self, rot, tran):
        dev = self.cam.device
        return (torch.as_tensor(rot, device=dev),
                torch.as_tensor(tran, device=dev))

    # -- rendering ---------------------------------------------------------
    @torch.no_grad()
    def get_renders(self, params: Dict, active, w2c: np.ndarray):
        """(rgb, depth, silhouette) at a pose (`ros_handler.py:955-985`)."""
        rot, tran = _w2c_rt(np.asarray(w2c))
        out, _ = render_for_loss(
            self._gauss(params), *self._pose(rot, tran), self.cam,
            self.raster_cfg, gaussians_grad=False, camera_grad=False,
        )
        return out.color[:3], out.color[3:4], out.color[4]

    # -- Fisher bookkeeping --------------------------------------------------
    def compute_hessian(self, params: Dict, active, w2c: np.ndarray) -> np.ndarray:
        """(N, 4) diagonal Fisher at a pose (`ros_handler.py:839-902`)."""
        rot, tran = _w2c_rt(np.asarray(w2c))
        h = render_fisher(self._gauss(params), active, *self._pose(rot, tran),
                          self.cam, self.raster_cfg,
                          seed_value=self.cfg.fisher_seed)
        return h.cpu().numpy()

    def add_visited_pose(self, c2w: np.ndarray) -> None:
        self.visited_poses.append(np.asarray(c2w))

    def recompute_h_train_inv(self, params: Dict, active) -> None:
        """H_train_inv over the Monte-Carlo-subsampled visited poses
        (`ros_handler.py:807-829`), drawn from the shared generator as in
        the JAX package."""
        if not self.visited_poses:
            return
        t0 = time.perf_counter()
        poses = self.visited_poses
        mc = self.cfg.monte_carlo
        if mc is not None and len(poses) > mc:
            idx = self.rng.choice(len(poses), mc, replace=False)
            poses = [poses[i] for i in idx]
        rots = np.zeros((len(poses), 4), np.float32)
        trans = np.zeros((len(poses), 3), np.float32)
        for i, c2w in enumerate(poses):
            rots[i], trans[i] = _w2c_rt(np.linalg.inv(c2w))
        h_train, _ = fisher_h_train(
            self._gauss(params), active, *self._pose(rots, trans),
            np.ones(len(poses), np.float32), self.cam, self.raster_cfg,
            seed_value=self.cfg.fisher_seed,
        )
        self._h_train_inv_dev = 1.0 / (h_train + self.cfg.h_train_eps)
        self.h_train_inv = self._h_train_inv_dev.cpu().numpy()
        _sync(self.cam.device)
        self.timing["h_train"].append(time.perf_counter() - t0)
        self.counts["h_train_poses"] += len(poses)

    def aligned_h_train_inv(self, n: int) -> Optional[torch.Tensor]:
        """``h_train_inv`` lined up with a map of ``n`` rows: the rows of
        the last recompute, then 1 / eps for rows appended since. Raises if
        the map lost rows since then (pruning renumbers rows; recompute
        first)."""
        if self._h_train_inv_dev is None:
            return None
        m = self._h_train_inv_dev.shape[0]
        if n < m:
            raise ValueError(
                f"the map has {n} rows, fewer than the {m} of the last "
                "recompute_h_train_inv: call it again after pruning"
            )
        if n == m:
            return self._h_train_inv_dev
        fresh = torch.full((n - m, 4), 1.0 / self.cfg.h_train_eps,
                           device=self._h_train_inv_dev.device)
        return torch.cat([self._h_train_inv_dev, fresh])

    def compute_eig_score(self, params: Dict, active, w2c: np.ndarray) -> float:
        if self.h_train_inv is None:
            return 0.0
        h = self.compute_hessian(params, active, w2c)
        hinv = self.aligned_h_train_inv(h.shape[0]).cpu().numpy()
        return float(np.sum(h * hinv))

    # -- gains ---------------------------------------------------------------
    def compute_gains(
        self,
        params: Dict,
        active,
        candidate_pose_vecs: Sequence[np.ndarray],
    ) -> List[Dict[str, float]]:
        """Score candidate planner poses ([tx ty tz qx qy qz qw] each);
        ``send_gains`` parity (`ros_handler.py:251-359`)."""
        cfg = self.cfg
        if not candidate_pose_vecs:
            return []
        t0 = time.perf_counter()
        gauss = self._gauss(params)
        use_eig = cfg.k_eig != 0 and self._h_train_inv_dev is not None
        n = len(candidate_pose_vecs)
        rots = np.zeros((n, 4), np.float32)
        trans = np.zeros((n, 3), np.float32)
        for i, vec in enumerate(candidate_pose_vecs):
            pose_mat = pose_matrix_from_quaternion(np.asarray(vec))
            if self.initial_pose is not None:
                pose_mat = relative_transformation(self.initial_pose, pose_mat)
            rots[i], trans[i] = _w2c_rt(np.linalg.inv(pose_mat))
        hinv = (self.aligned_h_train_inv(gauss["means3D"].shape[0])
                if use_eig else None)
        sils, eigs, _ = fisher_gains_batch(
            gauss, active, *self._pose(rots, trans), np.ones(n, np.float32),
            self.cam, self.raster_cfg, hinv, cfg.fisher_seed,
        )
        out = torch.cat([sils, eigs]).cpu().numpy()
        results = []
        for i in range(n):
            g_sil = float(out[i]) * cfg.k_sil
            g_eig = float(out[n + i]) * cfg.k_eig
            if cfg.nl_sil:
                g_sil = _nonlinear(g_sil)
            if cfg.nl_eig:
                g_eig = _nonlinear(g_eig)
            results.append(
                {"sil": g_sil, "eig": g_eig, "gain": cfg.k_sum * (g_eig + g_sil)}
            )
        self.timing["gains"].append(time.perf_counter() - t0)
        self.counts["gain_candidates"] += n
        return results
