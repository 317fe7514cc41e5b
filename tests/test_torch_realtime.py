"""The port's realtime driver, dump/replay and realtime CLI on the CPU.

The JAX driver is not run as a reference here (one run of its own test,
tests/test_realtime.py, takes minutes on the CPU); the port runs that
test's scenario and is held to what it checks. The handler itself is held
against the JAX package's in tests/test_torch_fisher.py.
"""
import os

import numpy as np
import pytest
import torch

from splatam_torch.data.synthetic import SyntheticDataset
from splatam_torch.realtime import (
    GainConfig,
    ReplaySource,
    associate_timestamps,
    pose_matrix_from_quaternion,
    realtime_slam,
    relative_transformation,
)
from splatam_torch.render import raster
from splatam_torch.utils.dump import DumpedDataset, dump_dataset

from tests.test_realtime import _config

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)


ITERS = 4  # tracking and mapping iterations per frame (the JAX test's 8,
# halved to keep this file and tests/test_torch_fisher.py within 45 s)


def _scenario_config():
    config = _config()
    config["tracking"]["num_iters"] = ITERS
    config["mapping"]["num_iters"] = ITERS
    return config


@pytest.fixture(scope="module")
def run():
    """tests/test_realtime.py's scenario: its config, 5 frames at 64x48,
    gains for two candidates requested before frame 3."""
    ds = SyntheticDataset(num_frames=5, width=64, height=48, seed=0,
                          device="cpu")
    candidates = [
        np.array([0.0, 0.0, 0.0, 0, 0, 0, 1.0]),
        np.array([0.0, 0.0, -2.5, 0, 0, 0, 1.0]),
    ]
    source = ReplaySource(ds, gain_requests={3: candidates})
    state, handler = realtime_slam(
        _scenario_config(), source,
        gain_cfg=GainConfig(k_sil=1.0, k_eig=1.0, k_sum=1.0, monte_carlo=4),
        progress=False, device="cpu",
    )
    return ds, source, state, handler


def test_realtime_slam_with_gains(run):
    _, source, state, handler = run
    assert state.params["means3D"].shape[0] > 100
    assert len(handler.visited_poses) == 5
    assert handler.h_train_inv is not None and handler.h_train_inv.shape[1] == 4
    assert handler.h_train_inv.shape[0] == state.params["means3D"].shape[0]
    assert np.all(handler.h_train_inv > 0)

    assert len(source.published) == 1
    gains = source.published[0]
    assert len(gains) == 2
    for g in gains:
        assert np.isfinite(g["gain"]) and g["sil"] >= 0 and g["eig"] > 0
    # the far-away pose sees mostly unmapped space -> higher silhouette gain
    assert gains[1]["sil"] > gains[0]["sil"]
    # the config sets no layout: tracking and mapping run split, as in JAX
    assert state.layout == "split"
    # H_train over at most 4 Monte-Carlo poses per frame: 1 + 2 + 3 + 4 + 4
    assert handler.counts == {"h_train_poses": 14, "gain_candidates": 2}
    assert state.counts["tracking_iters"] == 4 * ITERS
    assert state.counts["mapping_iters"] == 5 * ITERS
    assert len(state.timing["frame"]) == 5
    assert state.keyframe_time_indices == [0, 1, 3]


def test_realtime_tracks_the_sequence(run):
    from splatam_torch.eval.ate import evaluate_ate, trajectory_from_params

    _, _, state, _ = run
    gt, est = trajectory_from_params(state.params, state.first_w2c,
                                     state.gt_w2c_all)
    assert evaluate_ate(gt, est) < 0.03


def test_dump_replay_round_trip(tmp_path, run):
    """The port's dump reads back, in the port and in the JAX package."""
    from splatam_tpu.utils.dump import DumpedDataset as JDumped

    ds = run[0]
    dump_dataset([ds[0], ds[1]], str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["frame_000000.npz",
                                            "frame_000001.npz"]
    for replay in (DumpedDataset(str(tmp_path)), JDumped(str(tmp_path))):
        assert len(replay) == 2
        for i in range(2):
            for got, ref in zip(replay[i], ds[i]):
                np.testing.assert_array_equal(got, ref)
    with pytest.raises(FileNotFoundError):
        DumpedDataset(str(tmp_path / "empty"))


CLI_CONFIG = """
config = dict(
    workdir="{workdir}", run_name="rt_0", seed=0,
    map_every=1, keyframe_every=2, mapping_window_size=4,
    scene_radius_depth_ratio=3, mean_sq_dist_method="projective",
    gaussian_distribution="isotropic",
    raster=dict(chunk=64),
    data=dict(num_frames=-1),
    tracking=dict(
        use_gt_poses=False, forward_prop=True, num_iters=2,
        use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
        ignore_outlier_depth_loss=False,
        loss_weights=dict(im=0.5, depth=1.0),
        lrs=dict(cam_unnorm_rots=0.002, cam_trans=0.004),
    ),
    mapping=dict(
        num_iters=3, add_new_gaussians=True, sil_thres=0.5, use_l1=True,
        use_sil_for_loss=False, ignore_outlier_depth_loss=False,
        loss_weights=dict(im=0.5, depth=1.0),
        lrs=dict(means3D=0.0001, rgb_colors=0.0025, unnorm_rotations=0.001,
                 logit_opacities=0.05, log_scales=0.001,
                 cam_unnorm_rots=0.0, cam_trans=0.0),
        prune_gaussians=False,
        use_gaussian_splatting_densification=False,
    ),
)
"""


def test_realtime_cli_replay(tmp_path):
    """``python -m splatam_torch.run.realtime <config> --replay <dir>
    --device cpu`` on a tiny dumped stream, with the realtime flags."""
    from splatam_torch.run.realtime import main

    ds = SyntheticDataset(num_frames=2, width=32, height=24, seed=0,
                          device="cpu")
    dump_dir = str(tmp_path / "dump")
    dump_dataset(ds, dump_dir)
    cfg = tmp_path / "rt.py"
    cfg.write_text(CLI_CONFIG.format(workdir=tmp_path / "experiments"))
    before = {k: raster.KERNELS[k].launches for k in raster.KERNELS}
    state, handler = main(
        [str(cfg), "--replay", dump_dir, "--device", "cpu", "--k_sil", "500.0",
         "--k_eig", "0.2", "--nl_sil", "--n_monte", "10", "--map_iter", "2",
         "--median_scale", "40.0"]
    )
    assert handler.cfg.k_sil == 500.0 and handler.cfg.k_eig == 0.2
    assert handler.cfg.nl_sil is True and handler.cfg.monte_carlo == 10
    assert state.counts["mapping_iters"] == 2 * 2
    assert state.keyframe_time_indices == [0, 1]
    assert handler.h_train_inv.shape == (state.params["means3D"].shape[0], 4)
    assert os.path.exists(tmp_path / "experiments" / "rt_0" / "config.py")
    # no kernel launches on the CPU: the plain versions ran
    assert {k: raster.KERNELS[k].launches for k in raster.KERNELS} == before


def test_realtime_cli_needs_a_source(tmp_path, monkeypatch):
    """Without ROS and without --replay the CLI stops with a clear message."""
    from splatam_torch.realtime import ros_bridge
    from splatam_torch.run.realtime import main

    monkeypatch.setattr(ros_bridge, "HAS_ROS", False)
    cfg = tmp_path / "rt.py"
    cfg.write_text(CLI_CONFIG.format(workdir=tmp_path / "experiments"))
    with pytest.raises(SystemExit, match="--replay"):
        main([str(cfg), "--device", "cpu"])


def test_pose_helpers():
    a = np.array([0.0, 0.1, 0.2, 0.35])
    b = np.array([0.01, 0.11, 0.29])
    pairs = associate_timestamps(a, b, max_dt=0.08)
    assert (0, 0) in pairs and (1, 1) in pairs
    assert not any(i == 2 for i, _ in pairs)
    pose = pose_matrix_from_quaternion(
        np.array([1.0, 2.0, 3.0, 0.0, 0.0, np.sin(0.25), np.cos(0.25)]))
    np.testing.assert_allclose(pose[:3, 3], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3),
                               atol=1e-12)
    np.testing.assert_allclose(relative_transformation(pose, pose), np.eye(4),
                               atol=1e-12)
