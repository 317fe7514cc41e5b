"""The SLAM keys the shipped configs set, and the SLAM CLI on a dataset on
disk: the port's rgbd_slam against the JAX package's with fixed binning,
the depth-loss-threshold doubling, separate tracking and densification
resolutions and global progress reports; ``python -m splatam_torch.run.slam``
end to end, with a checkpoint resume."""
import os

import numpy as np
import pytest
import torch

from splatam_torch.core.params import get_pose, num_gaussians
from splatam_torch.core.transforms import pose_to_w2c
from splatam_torch.data.synthetic import SyntheticDataset
from splatam_torch.slam.pipeline import rgbd_slam

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

W, H, FRAMES = 64, 48, 3
TRACK = DENSE = (32, 24)  # tracking and densification at half


def _config(**tracking):
    cfg = dict(
        seed=0, map_every=1, keyframe_every=2, mapping_window_size=8,
        scene_radius_depth_ratio=3, gaussian_distribution="isotropic",
        report_global_progress_every=2,
        map_capacity=8192,  # JAX pre-sizes its map (no regrowth compiles)
        raster=dict(max_instances=2**15, max_per_tile=2048, chunk=64,
                    layout="aligned"),
        data=dict(num_frames=FRAMES),
        tracking=dict(
            use_gt_poses=False, forward_prop=True, num_iters=1,
            fixed_binning=True, use_depth_loss_thres=True,
            depth_loss_thres=0.0,  # every tracked frame doubles
            use_sil_for_loss=True, sil_thres=0.99,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(cam_unnorm_rots=0.0004, cam_trans=0.002),
        ),
        mapping=dict(
            num_iters=1, rebin_every=0, add_new_gaussians=True, sil_thres=0.5,
            use_sil_for_loss=False, ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(means3D=1e-4, rgb_colors=2.5e-3, unnorm_rotations=1e-3,
                     logit_opacities=0.05, log_scales=1e-3,
                     cam_unnorm_rots=0.0, cam_trans=0.0),
            prune_gaussians=True,
            pruning_dict=dict(start_after=0, remove_big_after=0, stop_after=20,
                              prune_every=20, removal_opacity_threshold=0.005,
                              final_removal_opacity_threshold=0.005,
                              reset_opacities=False, reset_opacities_every=500),
        ),
    )
    cfg["tracking"].update(tracking)
    return cfg


def _frames(w, h, n=FRAMES):
    ds = SyntheticDataset(num_frames=n, width=w, height=h, seed=0, device="cpu")
    return [ds[t] for t in range(n)]


@pytest.fixture(scope="module")
def runs():
    """On the same frames at two resolutions (the map's, and half for
    tracking and densification): the JAX run, whose jnp path bins afresh
    every iteration whatever ``fixed_binning`` says; the port binning every
    iteration too; and the port binning once per tracking call
    (``fixed_binning``). Each with its resumed (doubled) tracking calls
    counted, and the frames each reports progress after (JAX's reports
    are recorded, not rendered: they do not touch its poses). In the
    fixed-binning run every tracking loss is also
    recomputed with a binning made at that frame's start pose (the
    binning ``fixed_binning`` must use), and with one made at the pose the
    loss is taken at."""
    from splatam_tpu.eval import report as jreport
    from splatam_tpu.slam import pipeline as jpipeline

    from splatam_torch.core.losses import compute_binned
    from splatam_torch.slam import pipeline, tracking

    frames, track = _frames(W, H), _frames(*TRACK)
    dense = track
    resumed = {}
    jtrack = jpipeline.track_frame

    def counted(*args, **kwargs):
        resumed["jax"] = resumed.get("jax", 0) + (kwargs.get("resume") is not None)
        return jtrack(*args, **kwargs)

    reports = {"jax": [], "torch": []}
    treport = pipeline.report_progress

    def report(*args, **kwargs):  # time_idx follows the port's camera args
        reports["torch"].append(args[5])
        return treport(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "track_frame", counted)
        mp.setattr(jreport, "report_progress",
                   lambda *args, **kwargs: reports["jax"].append(args[6]))
        jstate = jpipeline.rgbd_slam(_config(), frames, tracking_dataset=track,
                                     densify_dataset=dense, progress=False)
        mp.setattr(pipeline, "report_progress", report)
        seen = []
        exact = rgbd_slam(_config(fixed_binning=False, rebin_every=0), frames,
                          tracking_dataset=track, densify_dataset=dense,
                          progress=False, device="cpu",
                          frame_callback=lambda t, s: seen.append(t))
    # (loss, loss binned at the frame's start pose, loss binned afresh)
    losses, start = [], {}
    ttrack, tloss = pipeline.track_frame, tracking.slam_loss

    def track_call(params, rot0, tran0, *args, **kwargs):
        if kwargs.get("resume") is None:  # the frame's first call
            start.update(rot=rot0.detach().clone(), tran=tran0.detach().clone())
        return ttrack(params, rot0, tran0, *args, **kwargs)

    def loss_call(params, rot, tran, im, depth, cam, cfg, **kwargs):
        out = tloss(params, rot, tran, im, depth, cam, cfg, **kwargs)
        with torch.no_grad():
            rot, tran = rot.detach(), tran.detach()
            again = [tloss(params, rot, tran, im, depth, cam, cfg,
                           **{**kwargs, "binned": compute_binned(
                               params, *pose, cam, cfg)}).loss.item()
                     for pose in ((start["rot"], start["tran"]), (rot, tran))]
        losses.append((out.loss.item(), *again))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "track_frame", track_call)
        mp.setattr(tracking, "slam_loss", loss_call)
        fixed = rgbd_slam(_config(), frames, tracking_dataset=track,
                          densify_dataset=dense, progress=False, device="cpu")
    resumed["torch"] = exact.counts["tracking_doubled"]
    resumed["torch_fixed"] = fixed.counts["tracking_doubled"]
    return jstate, exact, fixed, resumed, seen, losses, reports


def _gaps(jstate, state, t):
    """(translation gap in m, rotation gap in degrees) at frame t."""
    from splatam_tpu.core.params import get_pose as jget_pose
    from splatam_tpu.core.transforms import pose_to_w2c as jpose_to_w2c

    jw = np.asarray(jpose_to_w2c(*jget_pose(jstate.params, t)))
    tw = pose_to_w2c(*get_pose(state.params, t)).numpy()
    cos = (np.trace(tw[:3, :3].T @ jw[:3, :3]) - 1) / 2
    return (float(np.abs(tw[:3, 3] - jw[:3, 3]).max()),
            float(np.degrees(np.arccos(np.clip(cos, -1, 1)))))


def test_new_keys_match_jax(runs):
    """The doubling (on every tracked frame, on both sides), tracking and
    densification at 32x24 and progress reports every 2 frames:
    binning every iteration as the JAX run does, the poses agree to
    tests/test_torch_slam.py::test_poses_match_jax's tolerance and the maps
    hold the same number of Gaussians."""
    jstate, exact, _, resumed, seen, _, reports = runs
    assert resumed["jax"] == resumed["torch"] == FRAMES - 1
    assert exact.counts["tracking_iters"] == (
        2 * _config()["tracking"]["num_iters"] * (FRAMES - 1))
    assert seen == list(range(FRAMES))
    # report_global_progress_every=2: after frames 1 and 2 (the last)
    assert reports["jax"] == reports["torch"] == [1, 2]
    assert exact.counts["progress_renders"] == 2
    for t in range(1, FRAMES):
        dt, dr = _gaps(jstate, exact, t)
        assert dt < 1e-4 and dr < 0.01, (t, dt, dr)
    assert num_gaussians(exact.params) == int(
        np.asarray(jstate.variables["active"]).sum())


def test_fixed_binning_stays_near_jax(runs):
    """With the config's fixed_binning (one binning per tracking call, at
    the frame's start pose) the poses stay within 1.5x of the gaps measured
    to the JAX run (0.060 and 0.121 mm, 0 and 0.028 degrees at frames 1 and
    2): the doubled call's iteration renders with the start pose's
    binning, which leaves out or keeps a few (gaussian, tile) pairs at the
    tile edges that a fresh one would not."""
    jstate, _, fixed, resumed, _, _, _ = runs
    assert resumed["torch_fixed"] == FRAMES - 1
    for t in range(1, FRAMES):
        dt, dr = _gaps(jstate, fixed, t)
        assert dt < 9e-5 * t and dr < 0.021 * t, (t, dt, dr)


def test_fixed_binning_bins_at_the_start_pose(runs):
    """Every tracking loss of the fixed-binning run, the doubled calls'
    too, equals the loss with a binning made at its frame's start pose; at
    the frame's first iteration that is a fresh binning, and at later
    poses a fresh binning gives another loss: a binning made at another
    pose, or kept from an earlier frame, fails."""
    losses = runs[5]
    per_frame = 2 * _config()["tracking"]["num_iters"]  # doubled
    assert len(losses) == per_frame * (FRAMES - 1)
    for i, (loss, at_start, fresh) in enumerate(losses):
        assert loss == at_start, (i, loss, at_start)
        if i % per_frame == 0:
            assert loss == fresh, (i, loss, fresh)
    assert sum(loss != fresh for loss, _, fresh in losses) >= FRAMES - 1


def test_fixed_binning_bins_once_per_frame(monkeypatch):
    """tracking.fixed_binning bins once per tracked frame (at its first
    pose), where rebin_every alone would bin every 2 iterations."""
    from splatam_torch.slam import tracking

    calls = []
    orig = tracking.compute_binned

    def counted(*args, **kwargs):
        calls.append(kwargs.get("depth_cap"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(tracking, "compute_binned", counted)
    frames = _frames(16, 12, 2)
    cfg = _config(fixed_binning=True, use_depth_loss_thres=False,
                  num_iters=4, rebin_every=2)
    cfg["data"]["num_frames"] = 2
    cfg["report_global_progress_every"] = 0
    rgbd_slam(cfg, frames, progress=False, device="cpu")
    assert calls == [None]  # frame 1, no saturation cap
    calls.clear()
    cfg["tracking"]["fixed_binning"] = False
    rgbd_slam(cfg, frames, progress=False, device="cpu")
    assert len(calls) == 2


def _replica_scene(tmp_path):
    """tests/test_cli.py's replica_scene (6 frames at 64x48 in Replica's
    format: JPEG color, 16-bit PNG depth at 6553.5, traj.txt, a dataset
    YAML) with its writers, rendered by the port's SyntheticDataset (the
    JAX one renders eagerly, about 12 s here)."""
    from tests.test_datasets import _write_jpg, _write_png16

    ds = SyntheticDataset(num_frames=6, width=64, height=48, seed=0,
                          device="cpu")
    seq = tmp_path / "data" / "room0"
    (seq / "results").mkdir(parents=True)
    lines = []
    for i in range(6):
        color, depth, _, pose = ds[i]
        _write_jpg(seq / "results" / f"frame{i:06d}.jpg", color)
        _write_png16(seq / "results" / f"depth{i:06d}.png",
                     depth[..., 0] * 6553.5)
        lines.append(" ".join(str(v) for v in np.asarray(pose).ravel()))
    (seq / "traj.txt").write_text("\n".join(lines) + "\n")
    yaml = tmp_path / "replica.yaml"
    k = ds.k
    yaml.write_text(
        "dataset_name: 'replica'\n"
        "camera_params:\n"
        "  image_height: 48\n  image_width: 64\n"
        f"  fx: {k[0][0]}\n  fy: {k[1][1]}\n  cx: {k[0][2]}\n  cy: {k[1][2]}\n"
        "  png_depth_scale: 6553.5\n  crop_edge: 0\n"
    )
    return tmp_path, yaml


def test_slam_cli_end_to_end(tmp_path):
    """``python -m splatam_torch.run.slam <exp.py> --device cpu`` on
    tests/test_cli.py's Replica-format sequence and config, cut to 4
    frames: params.npz (loadable by the JAX package), splat.ply,
    eval/psnr.txt with mean PSNR > 15, a checkpoint at frame 3 that a
    second run resumes from."""
    from splatam_tpu.utils.checkpoint import load_params as jload_params
    from tests.test_cli import _write_config

    from splatam_torch.run import slam

    tmp, yaml = _replica_scene(tmp_path)
    workdir = str(tmp_path / "experiments")
    cfg = _write_config(tmp, yaml, workdir)
    # 1 tracking and 1 mapping iteration per frame (the JAX CLI test runs
    # 10), 4 of the sequence's 6 frames
    cfg.write_text(cfg.read_text().replace("num_iters=10", "num_iters=1")
                   .replace("num_frames=-1", "num_frames=4"))
    state, results = slam.main([str(cfg), "--device", "cpu"])

    run_dir = os.path.join(workdir, "test_0")
    for f in ("params.npz", "splat.ply", "params3.npz",
              "keyframe_time_indices3.npy", "config.py"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    psnr = np.loadtxt(os.path.join(run_dir, "eval", "psnr.txt"))
    assert psnr.shape == (4,) and np.mean(psnr) > 15.0, psnr
    assert results["frames"] == 4 and results["ate_rmse"] < 0.05
    jparams, jvars, extras = jload_params(os.path.join(run_dir, "params.npz"))
    assert int(np.asarray(jvars["active"]).sum()) == num_gaussians(state.params)
    assert extras["gt_w2c_all_frames"].shape == (4, 4, 4)

    resume = tmp / "exp_resume.py"
    resume.write_text(cfg.read_text().replace(
        "load_checkpoint=False", "load_checkpoint=True").replace(
        "checkpoint_time_idx=0", "checkpoint_time_idx=3"))
    state2, results2 = slam.main([str(resume), "--device", "cpu"])
    assert state2.counts["tracking_iters"] == 1  # frame 3
    assert len(state2.gt_w2c_all) == 4
    kf = np.load(os.path.join(run_dir, "keyframe_time_indices3.npy"))
    assert state2.keyframe_time_indices[:len(kf[kf < 3])] == list(kf[kf < 3])
    assert np.mean(np.loadtxt(os.path.join(run_dir, "eval", "psnr.txt"))) > 15.0
    assert results2["ate_rmse"] < 0.05


def test_slam_cli_defaults_to_cuda(tmp_path, monkeypatch):
    from splatam_torch.run import slam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        slam.main([str(tmp_path / "absent.py")])
