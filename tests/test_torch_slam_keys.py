"""The SLAM keys the port ran last: the "knn" scale rule, bundle adjustment
in mapping (``mapping.do_ba``), Inria densification inside mapping, the
tracking-loss figures and wandb logging; each against the JAX package where
it computes something, and through the port's ``rgbd_slam``."""
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from splatam_torch.core.optim import AdamState
from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose, params_from_numpy
from splatam_torch.data.synthetic import SyntheticDataset
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera
from splatam_torch.slam import pipeline
from splatam_torch.slam.mapping import map_step
from splatam_torch.slam.pipeline import as_frame, rgbd_slam
from splatam_torch.utils import neighbors

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

W, H = 32, 24
# JAX's capacities hold every pair of frame 0's 768 Gaussians and 4 tiles
RASTER = dict(max_instances=2**12, max_per_tile=1024, chunk=64, layout="aligned")
LRS = dict(means3D=1e-4, rgb_colors=2.5e-3, unnorm_rotations=1e-3,
           logit_opacities=0.05, log_scales=1e-3, cam_unnorm_rots=4e-4,
           cam_trans=2e-3)


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(num_frames=2, width=W, height=H, seed=0, device="cpu")
    return [ds[t] for t in range(2)]


@pytest.fixture(scope="module")
def small():
    """Two frames at 16x12, for the runs of the port's rgbd_slam."""
    ds = SyntheticDataset(num_frames=2, width=16, height=12, seed=0,
                          device="cpu")
    return [ds[t] for t in range(2)]


def test_knn_matches_jax(frames):
    """knn, its self-KNN and mean squared distance on a seeded cloud, with a
    chunk that does not divide it; then get_pointcloud's "knn" scales on
    frame 0 (the cloud has frame 0's size: one JAX compile serves both)."""
    from splatam_tpu.slam.initialize import get_pointcloud as jget_pointcloud
    from splatam_tpu.utils import neighbors as jneighbors

    from splatam_torch.slam.initialize import get_pointcloud

    color, depth, k4, pose = frames[0]
    chw = np.transpose(color, (2, 0, 1)) / 255.0, np.transpose(depth, (2, 0, 1))
    mask = chw[1][0].reshape(-1) > 0
    n = int(mask.sum())
    assert n % 100
    pts = np.random.default_rng(0).uniform(-1, 1, (n, 3)).astype(np.float32)
    jd, ji = jneighbors.knn(jax.numpy.asarray(pts), jax.numpy.asarray(pts), k=4)
    d, i = neighbors.knn(torch.as_tensor(pts), torch.as_tensor(pts), k=4,
                         chunk=100)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=2e-6)
    assert (i[:, 0].numpy() == np.arange(n)).all()
    msd = neighbors.mean_squared_knn_distance(torch.as_tensor(pts), chunk=100)
    ref = np.clip(np.asarray(jd)[:, 1:].mean(-1), 1e-7, None)
    np.testing.assert_allclose(msd.numpy(), ref, rtol=1e-4, atol=2e-6)

    args = (*chw, k4[:3, :3].astype(np.float64), np.linalg.inv(pose))
    jcld, jmsd = jget_pointcloud(*args, mask=mask, compute_mean_sq_dist=True,
                                 mean_sq_dist_method="knn")
    cld, msd = get_pointcloud(*args, mask=mask, compute_mean_sq_dist=True,
                              mean_sq_dist_method="knn", device="cpu")
    np.testing.assert_array_equal(cld, jcld)
    # both sides take ||q||^2 + ||p||^2 - 2 q.p in float32, a difference of
    # terms near ||p||^2 (~10 m^2 here), rounded in another order: a few
    # float32 ulps of the largest ||p||^2
    tol = 8 * np.finfo(np.float32).eps * (cld[:, :3] ** 2).sum(-1).max()
    np.testing.assert_allclose(msd, jmsd, rtol=0, atol=tol)
    assert np.abs(msd - jmsd).max() < 0.01 * jmsd.min()


def test_map_step_ba_matches_jax(frames):
    """Two mapping steps with bundle adjustment and the screen-space mean
    gradients, each from the same state in both packages (the second from
    JAX's state after the first: carried Gaussian and pose moments, step
    2): the loss, the gradients (as the first moments), the updated
    Gaussians and pose, the means2D gradient norms and the seen mask."""
    from splatam_tpu.core.optim import init_adam as jinit_adam
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.slam.initialize import initialize_first_timestep as jinit
    from splatam_tpu.slam.mapping import map_step as jmap_step
    from splatam_tpu.slam.pipeline import _as_frame

    color, depth, k4, pose = frames[0]
    jparams, jvars, _, _, jcam, _ = jinit(color, depth, k4, pose, 3, 3)
    gauss = {k: jparams[k] for k in GAUSSIAN_KEYS}
    active = np.asarray(jvars["active"])
    # keyframe 1's image at a pose 1 cm / ~0.6 degrees off its own, so the
    # pose gradient is far from zero
    w2c = np.linalg.inv(frames[1][3]).astype(np.float32)
    rot = np.array([0.999, 0.004, -0.003, 0.002], np.float32)
    tran = w2c[:3, 3] + np.float32(0.01)
    im, d = _as_frame(frames[1][0], frames[1][1])
    jpose = {"cam_unnorm_rots": jax.numpy.asarray(rot),
             "cam_trans": jax.numpy.asarray(tran)}
    jopt, jpose_opt = jinit_adam(gauss), jinit_adam(jpose)
    lr_items = tuple(sorted(LRS.items()))
    cam = setup_camera(W, H, k4[:3, :3], np.linalg.inv(pose), device="cpu")
    cfg = RasterConfig(**RASTER)
    for step in (1, 2):
        # the port starts from JAX's state before this step
        params, _ = params_from_numpy(gauss, jvars, device="cpu")
        opt = AdamState(
            mu={k: torch.as_tensor(np.asarray(jopt.mu[k])[active])
                for k in GAUSSIAN_KEYS},
            nu={k: torch.as_tensor(np.asarray(jopt.nu[k])[active])
                for k in GAUSSIAN_KEYS},
            step=torch.tensor(float(jopt.step)))
        pose_opt = AdamState(
            mu={k: torch.tensor(np.asarray(v)) for k, v in jpose_opt.mu.items()},
            nu={k: torch.tensor(np.asarray(v)) for k, v in jpose_opt.nu.items()},
            step=torch.tensor(float(jpose_opt.step)))
        rot_t = torch.tensor(np.asarray(jpose["cam_unnorm_rots"]))
        tran_t = torch.tensor(np.asarray(jpose["cam_trans"]))
        jres = jmap_step(gauss, jvars["active"], jopt, jpose["cam_unnorm_rots"],
                         jpose["cam_trans"], im, d, jcam, JCfg(**RASTER),
                         lr_items, track_means2d_grad=True, do_ba=True,
                         pose_opt=jpose_opt)
        res = map_step(params, opt, rot_t, tran_t, *as_frame(*frames[1][:2], "cpu"),
                       cam, cfg, LRS, track_means2d_grad=True, do_ba=True,
                       pose_opt=pose_opt)
        assert not bool(jres.overflow)
        np.testing.assert_allclose(float(res.losses["loss"]),
                                   float(jres.losses["loss"]), rtol=2e-5)
        assert float(opt.step) == int(jres.opt_state.step) == step
        for k in GAUSSIAN_KEYS:
            # the gradient as this step's share of the first moment
            g = opt.mu[k].numpy() - 0.9 * np.asarray(jopt.mu[k])[active]
            ref = (np.asarray(jres.opt_state.mu[k])[active]
                   - 0.9 * np.asarray(jopt.mu[k])[active])
            scale = np.abs(ref).max() + 1e-20
            np.testing.assert_allclose(g / scale, ref / scale, atol=5e-5,
                                       err_msg=k)
            # a step moves each entry by about lr; a sign that flips on a
            # gradient near zero moves it by up to 2 lr the other way
            np.testing.assert_allclose(
                params[k].numpy(), np.asarray(jres.params[k])[active],
                atol=2.0001 * LRS[k], err_msg=k)
        for k, new, jnew in (("cam_unnorm_rots", res.cam_rot, jres.cam_rot),
                             ("cam_trans", res.cam_tran, jres.cam_tran)):
            ref = np.asarray(jres.pose_opt.mu[k]) - 0.9 * np.asarray(jpose_opt.mu[k])
            g = res.pose_opt.mu[k].numpy() - 0.9 * np.asarray(jpose_opt.mu[k])
            scale = np.abs(ref).max()
            assert scale > 0, k
            np.testing.assert_allclose(g / scale, ref / scale, atol=5e-5,
                                       err_msg=k)
            np.testing.assert_allclose(new.numpy(), np.asarray(jnew),
                                       atol=2.0001 * LRS[k], err_msg=k)
            assert not np.allclose(new.numpy(), np.asarray(jpose[k]))
        ref = np.asarray(jres.means2d_grad_norm)[active]
        np.testing.assert_allclose(res.means2d_grad_norm.numpy() / ref.max(),
                                   ref / ref.max(), atol=5e-5)
        np.testing.assert_array_equal(res.seen.numpy(),
                                      np.asarray(jres.seen)[active])
        gauss, jopt = jres.params, jres.opt_state
        jpose = {"cam_unnorm_rots": jres.cam_rot, "cam_trans": jres.cam_tran}
        jpose_opt = jres.pose_opt


def _config(frames=2, **mapping):
    cfg = dict(
        seed=0, map_every=1, keyframe_every=1, mapping_window_size=4,
        scene_radius_depth_ratio=3, gaussian_distribution="isotropic",
        raster=dict(RASTER), data=dict(num_frames=frames), workdir="unused",
        tracking=dict(
            use_gt_poses=False, forward_prop=True, num_iters=1,
            use_sil_for_loss=True, sil_thres=0.99,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(cam_unnorm_rots=0.0004, cam_trans=0.002),
        ),
        mapping=dict(
            num_iters=1, rebin_every=0, add_new_gaussians=True, sil_thres=0.5,
            use_sil_for_loss=False, ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0), lrs=dict(LRS),
            prune_gaussians=False,
        ),
    )
    cfg["mapping"].update(mapping)
    return cfg


def _poses(state):
    return np.stack([torch.cat(get_pose(state.params, t)).numpy()
                     for t in range(2)])


def test_bundle_adjustment_moves_keyframes(small):
    """rgbd_slam with mapping.do_ba: at mapping cam lrs 0 the poses are
    those of the run without it, bit for bit; at the tracking lrs every
    keyframe's pose moves, each Adam step by at most about its lr."""
    def poses(cfg):
        return _poses(rgbd_slam(cfg, small, progress=False, device="cpu"))

    plain = poses(_config())
    still = _config(do_ba=True)
    still["mapping"]["lrs"].update(cam_unnorm_rots=0.0, cam_trans=0.0)
    np.testing.assert_array_equal(poses(still), plain)
    moved = poses(_config(do_ba=True))
    gap = np.abs(moved - plain).max(axis=1)
    steps = 2 * still["mapping"]["num_iters"]
    assert (gap > 1e-5).all() and gap.max() < 1.01 * steps * LRS["cam_trans"], gap


def test_densification_in_mapping_grows_on_schedule(small, monkeypatch):
    """mapping.use_gaussian_splatting_densification: the screen-space
    gradients accumulate while it <= stop_after, densify runs after every
    mapping step, and the map grows at the scheduled iterations only."""
    calls = []
    orig = pipeline.densify

    def densify(params, variables, opt, it, dd, radius, rng):
        n0 = params["means3D"].shape[0]
        denom = float(variables["denom"].sum())
        out = orig(params, variables, opt, it, dd, radius, rng)
        calls.append((it, n0, out[0]["means3D"].shape[0], denom))
        return out

    monkeypatch.setattr(pipeline, "densify", densify)
    dd = dict(start_after=1, remove_big_after=100, stop_after=2,
              densify_every=2, grad_thresh=1e-6, num_to_split_into=2,
              removal_opacity_threshold=0.0,
              final_removal_opacity_threshold=0.0, reset_opacities=False)
    cfg = _config(num_iters=3, use_gaussian_splatting_densification=True,
                  densify_dict=dd)
    state = rgbd_slam(cfg, small, progress=False, device="cpu")
    assert [c[0] for c in calls] == [0, 1, 2] * 2
    for it, n0, n1, denom in calls:
        assert (n1 > n0) == (it == 2), (it, n0, n1)
        # each step's seen Gaussians counted in, up to stop_after
        assert (denom > 0) == (it <= 2), (it, denom)
    assert state.counts["gs_densified"] == 2


def _segment_rule(num_iters, rebin, fixed):
    """The JAX pipeline's figure points (``splatam_tpu/slam/pipeline.py``
    ``run_track``): one figure per rebin segment, at the iterations done,
    or one at the end when binning is fixed or rebin_every is 0."""
    if not rebin or fixed:
        return [num_iters]
    done, out = 0, []
    while done < num_iters:
        done += min(rebin, num_iters - done)
        out.append(done)
    return out


@pytest.mark.parametrize("rebin,fixed", [(2, False), (2, True)])
def test_tracking_figures_follow_jax_segments(small, monkeypatch, rebin,
                                              fixed):
    """tracking.visualize_tracking_loss draws a figure at JAX's segment
    points, from the pose after those iterations and the frame tracked,
    into workdir/plots (two renders each; the drawing itself is
    test_tracking_figure_matches_jax's)."""
    drawn = []

    def record(im, depth, sil, frame_im, frame_depth, losses, plot_dir,
               iteration, time_idx, **kw):
        drawn.append((time_idx, iteration, plot_dir))
        np.testing.assert_array_equal(frame_im, as_frame(*small[1][:2],
                                                         "cpu")[0].numpy())
        assert im.shape == (3, 12, 16) and sil.shape == (12, 16)
        assert np.isfinite(losses["im"]) and kw["sil_thres"] == 0.99

    monkeypatch.setattr(pipeline, "save_tracking_loss_viz", record)
    cfg = _config(num_iters=0)
    cfg["tracking"].update(num_iters=3, rebin_every=rebin, fixed_binning=fixed,
                           visualize_tracking_loss=True)
    state = rgbd_slam(cfg, small, progress=False, device="cpu")
    points = _segment_rule(3, rebin, fixed)
    assert drawn == [(1, i, os.path.join("unused", "plots")) for i in points]
    assert state.counts["tracking_figures"] == len(points)


def test_tracking_figure_matches_jax(tmp_path, monkeypatch):
    """The port's save_tracking_loss_viz draws JAX's eight panels (weighted
    images, error maps, silhouette and loss masks, the outlier and
    silhouette rules both on) from the same inputs, and saves the figure
    under JAX's name (the saving stubbed: test_viz_cli_matches_jax_render
    writes a matplotlib PNG)."""
    import matplotlib.axes
    import matplotlib.figure

    from splatam_tpu.viz.plots import save_tracking_loss_viz as jviz

    from splatam_torch.viz.plots import save_tracking_loss_viz

    rng = np.random.default_rng(1)
    args = (rng.uniform(0, 1, (3, H, W)), rng.uniform(0, 4, (1, H, W)),
            rng.uniform(0.9, 1, (H, W)), rng.uniform(0, 1, (3, H, W)),
            rng.uniform(0, 4, (1, H, W)) * (rng.uniform(size=(1, H, W)) > 0.2),
            {"im": 123.4, "depth": 56.7})
    kw = dict(use_sil_for_loss=True, sil_thres=0.95,
              ignore_outlier_depth_loss=True, time_idx=3)
    panels = []
    imshow = matplotlib.axes.Axes.imshow
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", lambda ax, x, **k: (
        panels.append(np.array(x)), imshow(ax, x, **k))[1])
    saved = []
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda fig, path, **k: saved.append(path))
    path = save_tracking_loss_viz(*args, str(tmp_path / "torch"), 7, **kw)
    jpath = jviz(*args, str(tmp_path / "jax"), 7, **kw)
    assert saved == [path, jpath]
    assert os.path.relpath(path, tmp_path / "torch") == os.path.relpath(
        jpath, tmp_path / "jax") == os.path.join("tracking_0003", "0007.png")
    assert len(panels) == 16
    for got, ref in zip(panels[:8], panels[8:]):
        np.testing.assert_array_equal(got, ref)
    # the loss mask: valid depth, inside the silhouette, not an outlier
    assert panels[7].any() and not panels[7].all()
    assert (panels[7] <= panels[6]).all()


def test_wandb_logs_progress(small, monkeypatch, capsys):
    """use_wandb: a present wandb is initialised with config["wandb"] and
    receives the global progress reports; a missing one is reported and the
    run goes on."""
    inits, logs = [], []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: inits.append(kw) or types.SimpleNamespace(
        log=logs.append)
    cfg = _config(frames=1)
    cfg.update(use_wandb=True, wandb=dict(project="p", name="n"),
               report_global_progress_every=1)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    rgbd_slam(cfg, small, progress=False, device="cpu")
    assert inits == [dict(project="p", name="n")]
    assert len(logs) == 1 and np.isfinite(logs[0]["psnr"]), logs
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    state = rgbd_slam(cfg, small, progress=False, device="cpu")
    assert "wandb is not installed" in capsys.readouterr().out
    assert state.log_fn is None and state.counts["progress_renders"] == 1
