"""The slice as a whole: the port's rgbd_slam against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatam_torch.core.params import (
    GAUSSIAN_KEYS,
    get_pose,
    num_gaussians,
    params_from_numpy,
    params_to_numpy,
)
from splatam_torch.core.transforms import pose_to_w2c
from splatam_torch.data.synthetic import SyntheticDataset
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.render_tiled import rasterize_tiled
from splatam_torch.slam.pipeline import rgbd_slam

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

W, H, FRAMES = 80, 60, 4


def _config(rebin_every):
    return dict(
        seed=0, map_every=1, keyframe_every=2, mapping_window_size=8,
        scene_radius_depth_ratio=3, gaussian_distribution="isotropic",
        raster=dict(max_instances=2**15, max_per_tile=1024, chunk=64,
                    layout="aligned"),
        data=dict(num_frames=FRAMES),
        tracking=dict(
            use_gt_poses=False, forward_prop=True, num_iters=4,
            rebin_every=rebin_every, use_sil_for_loss=True, sil_thres=0.99,
            ignore_outlier_depth_loss=False,
            loss_weights=dict(im=0.5, depth=1.0),
            lrs=dict(cam_unnorm_rots=0.0004, cam_trans=0.002),
        ),
        mapping=dict(
            num_iters=4, rebin_every=rebin_every, add_new_gaussians=True,
            sil_thres=0.5, use_sil_for_loss=False,
            ignore_outlier_depth_loss=False,
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


@pytest.fixture(scope="module")
def runs():
    """On the same JAX-rendered frames: the JAX run (its jnp path bins
    afresh every iteration), the port binning every iteration too, and the
    port on its main path (binning frozen for 2 iterations, capped at the
    saturation depth)."""
    from splatam_tpu.data.synthetic import SyntheticDataset as JDataset
    from splatam_tpu.slam.pipeline import rgbd_slam as jrgbd_slam

    jds = JDataset(num_frames=FRAMES, width=W, height=H, seed=0)
    frames = [jds[i] for i in range(FRAMES)]
    jstate = jrgbd_slam(_config(0), frames, progress=False)
    exact = rgbd_slam(_config(0), frames, progress=False, device="cpu")
    frozen = rgbd_slam(_config(2), frames, progress=False, device="cpu")
    return jds, frames, jstate, exact, frozen


def _jax_w2c(jstate, t):
    from splatam_tpu.core.params import get_pose as jget_pose
    from splatam_tpu.core.transforms import pose_to_w2c as jpose_to_w2c

    return np.asarray(jpose_to_w2c(*jget_pose(jstate.params, t)))


def _gaps(jstate, state, t):
    """(translation gap in m, rotation gap in degrees) at frame t."""
    jw = _jax_w2c(jstate, t)
    tw = pose_to_w2c(*get_pose(state.params, t)).numpy()
    cos = (np.trace(tw[:3, :3].T @ jw[:3, :3]) - 1) / 2
    return (float(np.abs(tw[:3, 3] - jw[:3, 3]).max()),
            float(np.degrees(np.arccos(np.clip(cos, -1, 1)))))


def test_poses_match_jax(runs):
    """Binning every iteration, the port retraces the JAX run: poses agree
    to 0.1 mm and 0.01 degrees (observed: under 2e-5 m, and no rotation gap
    above float noise) and the maps hold the same number of Gaussians. The
    gap is float rounding only, but Adam normalizes each step by the
    gradient's own size, so rounding in a near-zero gradient component
    still moves the pose by a fraction of lr."""
    _, _, jstate, exact, _ = runs
    for t in range(1, FRAMES):
        dt, dr = _gaps(jstate, exact, t)
        assert dt < 1e-4 and dr < 0.01, (t, dt, dr)
    jn = int(np.asarray(jstate.variables["active"]).sum())
    assert num_gaussians(exact.params) == jn


def test_frozen_binning_poses_stay_near_jax(runs):
    """With binning frozen between rebins (the main path), each Adam step
    can go another way than in the JAX run by up to about lr per
    coordinate, and the constant-velocity start carries earlier frames'
    gaps forward: translation within 2 lr iters t, rotation within the
    matching quaternion bound, at frame t."""
    _, _, jstate, _, frozen = runs
    cfg = _config(2)["tracking"]
    iters, lr_t, lr_r = cfg["num_iters"], cfg["lrs"]["cam_trans"], cfg["lrs"]["cam_unnorm_rots"]
    for t in range(1, FRAMES):
        dt, dr = _gaps(jstate, frozen, t)
        assert dt < 2 * lr_t * iters * t, (t, dt)
        assert dr < np.degrees(4 * lr_r * iters * t), (t, dr)


def test_jax_map_renders_the_same_in_the_port(runs):
    """params_from_numpy of the JAX map renders the JAX image; the way back
    (params_to_numpy) restores the JAX layout."""
    from splatam_tpu.core.losses import render_for_loss as jrender
    from splatam_tpu.core.params import get_pose as jget_pose
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.camera import setup_camera as jsetup

    from splatam_torch.core.losses import render_for_loss
    from splatam_torch.render.binning import RasterConfig

    jds, _, jstate, _, _ = runs
    t = FRAMES - 1
    jcam = jsetup(W, H, jds.k, np.eye(4))
    jcfg = JCfg(max_instances=2**15, max_per_tile=1024, chunk=128,
                backend="jnp")
    rot, tran = jget_pose(jstate.params, t)
    gauss = {k: jstate.params[k] for k in GAUSSIAN_KEYS}
    jout, _ = jax.jit(lambda g, a, r, tr: jrender(
        g, a, r, tr, jcam, jcfg, gaussians_grad=False, camera_grad=False
    ))(gauss, jstate.variables["active"], rot, tran)

    np_params = {k: np.asarray(v) for k, v in jstate.params.items()}
    np_vars = {k: np.asarray(v) for k, v in jstate.variables.items()}
    params, variables = params_from_numpy(np_params, np_vars, device="cpu")
    cam = setup_camera(W, H, jds.k, np.eye(4), device="cpu")
    out, _ = render_for_loss(params, *get_pose(params, t), cam,
                             RasterConfig(chunk=128), gaussians_grad=False,
                             camera_grad=False)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(jout.color),
                               atol=1e-4, rtol=1e-4)
    back, back_vars = params_to_numpy(params, variables)
    active = np_vars["active"]
    for k in GAUSSIAN_KEYS:
        np.testing.assert_array_equal(back[k], np_params[k][active])
    assert back_vars["active"].all()


def test_synthetic_frames_match_jax(runs):
    """The port's own SyntheticDataset (rendered by the port) gives the JAX
    frames: color to 1e-3 of 255, depth where both see the scene."""
    jds, frames, _, _, _ = runs
    ds = SyntheticDataset(num_frames=FRAMES, width=W, height=H, seed=0,
                          device="cpu")
    for t in (0, FRAMES - 1):
        color, depth, k4, pose = ds[t]
        jcolor, jdepth, jk4, jpose = frames[t]
        np.testing.assert_allclose(color, jcolor, atol=0.255)
        np.testing.assert_array_equal(k4, jk4)
        np.testing.assert_array_equal(pose, jpose)
        both = (depth > 0) & (jdepth > 0)
        assert both.mean() > 0.95
        np.testing.assert_allclose(depth[both], jdepth[both], atol=1e-4)


@pytest.mark.parametrize("flags", [[], ["--fixed_binning"]])
def test_synthetic_cli_config_matches_jax(flags):
    """The port's synthetic-SLAM CLI builds the JAX CLI's config for the
    same arguments, ``tracking.fixed_binning`` included; only ``raster``
    differs (the port ignores the JAX capacities and backend)."""
    import argparse

    from splatam_torch.run import synthetic_slam as port_cli
    from splatam_tpu.run import synthetic_slam as jax_cli

    argv = ["--frames", "7", "--width", "96", "--height", "64",
            "--track_iters", "3", "--map_iters", "5", *flags]
    port = port_cli.build_config(port_cli.parse_args(argv))
    ref = jax_cli.build_config(argparse.Namespace(
        frames=7, width=96, height=64, track_iters=3, map_iters=5,
        backend="auto", fixed_binning=bool(flags)))
    assert port["tracking"]["fixed_binning"] is bool(flags)
    port.pop("raster")
    ref.pop("raster")
    assert port == ref
