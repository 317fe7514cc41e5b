"""The port's other command-line entry points end to end on a dataset on
disk (offline training, refinement, PLY export, the viewer, novel-view
evaluation on both splits), ``eval_nvs`` against the JAX package's, and
the evaluation's frame writer without imageio.

The CLIs run on tests/test_cli.py's 64x48 Replica-format scene (rendered by
the port's synthetic dataset) at 1 training iteration; the novel-view
test split is the same scene in Replica-V2's ``imap/00`` / ``imap/01``
layout (``chip_smoke.write_replica_v2``), its test poses halfway between
the train poses, and one past the last.
"""
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import write_replica_v2
from splatam_torch.run import (
    eval_novel_view,
    export_ply,
    gaussian_splatting,
    post_opt,
    viz,
)

from tests.test_cli import _write_config
from tests.test_torch_slam_cli import _replica_scene

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

W, H, FRAMES = 64, 48, 2
# the JAX references' capacities hold the trained map's (gaussian, tile)
# pairs, about 5,300 (tests/test_cli.py's 512 per tile would truncate their
# renders), and no more: the JAX jnp path's time grows with them
TRAIN = """
config["raster"].update(max_per_tile=2048, max_instances=2**14)
config["data"].update(num_frames=%d, eval_num_frames=%d, param_ckpt_path=%r)
config["train"] = dict(
    num_iters_mapping=1, sil_thres=0.5, use_sil_for_loss=True,
    loss_weights=dict(im=0.5, depth=1.0),
    lrs_mapping=dict(means3D=0.00032, rgb_colors=0.0025,
                     unnorm_rotations=0.001, logit_opacities=0.05,
                     log_scales=0.005),
    lrs_mapping_means3D_final=0.0000032, lr_delay_mult=0.01,
    use_gaussian_splatting_densification=False,
)
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The Replica-format scene, an experiment file for every CLI (the SLAM
    config of tests/test_cli.py with 2 frames and a ``train`` section of 1
    iteration, refining the map ``gaussian_splatting`` saves), the
    Replica-V2 copy with a test-split experiment file (a tracking-only
    run's: no mapping iterations, no new Gaussians), and the trained
    run."""
    tmp = tmp_path_factory.mktemp("clis")
    tmp, yaml = _replica_scene(tmp)
    workdir = tmp / "experiments"
    exp = _write_config(tmp, yaml, workdir)
    exp.write_text(exp.read_text() + TRAIN % (
        FRAMES, FRAMES, str(workdir / "test_0" / "params.npz")))
    v2 = tmp / "Replica_V2"
    v2_yaml = write_replica_v2(str(v2), "cpu", FRAMES, (W, H), tests=2)
    nvs = tmp / "exp_nvs.py"
    nvs.write_text(exp.read_text() + (
        f"config['data'].update(basedir={str(v2)!r}, "
        f"gradslam_data_cfg={str(v2_yaml)!r}, sequence='room_0', "
        "use_train_split=False, eval_num_frames=-1)\n"
        "config['mapping'].update(num_iters=0, add_new_gaussians=False)\n"))
    state, results = gaussian_splatting.main([str(exp), "--device", "cpu"])
    return dict(exp=str(exp), nvs=str(nvs), run=workdir / "test_0",
                state=state, results=results)


def test_gaussian_splatting_cli(scene):
    """``python -m splatam_torch.run.gaussian_splatting``: the map, its PLY,
    the evaluation of every frame, in the JAX package's formats."""
    from splatam_tpu.utils.checkpoint import load_params as jload_params

    run, results = scene["run"], scene["results"]
    for f in ("params.npz", "splat.ply", "config.py", "eval/psnr.txt"):
        assert (run / f).exists(), f
    assert results["frames"] == FRAMES and results["psnr"] > 15.0, results
    assert results["ate_rmse"] < 1e-6  # the ground-truth poses
    jparams, jvars, extras = jload_params(str(run / "params.npz"))
    assert int(np.asarray(jvars["active"]).sum()) == (
        scene["state"].params["means3D"].shape[0])
    assert extras["gt_w2c_all_frames"].shape == (FRAMES, 4, 4)


def test_post_opt_cli(scene):
    """``python -m splatam_torch.run.post_opt`` from the trained run's
    params.npz, with its poses held: the refined map stays near it."""
    state, results = post_opt.main([scene["exp"], "--device", "cpu",
                                    "--run_name", "post"])
    run = scene["run"].parent / "post"
    for f in ("params.npz", "splat.ply", "eval/psnr.txt"):
        assert (run / f).exists(), f
    assert state.counts["offline_iters"] == 1
    assert results["psnr"] > scene["results"]["psnr"] - 3.0, results
    np.testing.assert_array_equal(state.params["cam_trans"].numpy(),
                                  scene["state"].params["cam_trans"].numpy())


def test_export_ply_cli_matches_jax(scene, monkeypatch):
    """``python -m splatam_torch.run.export_ply`` writes the JAX CLI's file
    byte for byte (the JAX one is numpy only)."""
    from splatam_tpu.run import export_ply as jexport_ply

    ply = scene["run"] / "splat.ply"
    assert export_ply.main([scene["exp"], "--device", "cpu"]) == str(ply)
    ours = ply.read_bytes()
    monkeypatch.setattr(sys, "argv", ["export_ply", scene["exp"]])
    jexport_ply.main()
    assert ply.read_bytes() == ours


def test_viz_cli_matches_jax_render(scene, tmp_path):
    """``python -m splatam_torch.run.viz --every 1``: recon PNGs of both
    frames and the trajectory plot; frame 0 within 1/255 of the JAX
    package's render_trajectory (one jitted JAX render)."""
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.run.common import load_experiment_config as jload_config
    from splatam_tpu.utils.checkpoint import load_params as jload_params
    from splatam_tpu.viz.recon import render_trajectory as jrender

    pngs, plot = viz.main([scene["exp"], "--device", "cpu", "--every", "1"])
    run = scene["run"]
    assert [os.path.basename(p) for p in pngs] == ["recon_0000.png",
                                                  "recon_0001.png"]
    assert plot == str(run / "trajectory.png") and os.path.exists(plot)
    config = jload_config(scene["exp"])
    jparams, jvars, extras = jload_params(str(run / "params.npz"))
    jrender(jparams, jvars["active"], extras["intrinsics"][:3, :3],
            extras["w2c"], str(tmp_path), width=W, height=H,
            raster_cfg=JCfg(**config["raster"]), every=FRAMES)
    ours = cv2.imread(pngs[0]).astype(int)
    ref = cv2.imread(str(tmp_path / "recon_0000.png")).astype(int)
    assert ours.shape == (H, W, 3) and np.abs(ours - ref).max() <= 1


def test_online_replay_and_open3d_gate(scene, tmp_path, monkeypatch):
    """online_replay renders keyframe 0's view with the Gaussians made by
    then (not frame 1's); the Open3D views name the headless alternative
    where open3d does not import."""
    from splatam_torch.utils.checkpoint import load_params
    from splatam_torch.viz import (interactive_online_recon,
                                   interactive_recon, online_replay)

    params, variables, extras = load_params(
        str(scene["run"] / "params.npz"), device="cpu")
    args = (extras["intrinsics"][:3, :3], extras["w2c"])
    [path] = online_replay(params, variables["timestep"], *args,
                           str(tmp_path), width=W, height=H,
                           keyframe_time_indices=[0], device="cpu")
    assert os.path.basename(path) == "online_0000.png"
    assert 0 < int((variables["timestep"] <= 0).sum()) < len(params["means3D"])
    assert cv2.imread(path).shape == (H, W, 3)
    monkeypatch.setitem(sys.modules, "open3d", None)  # import raises
    with pytest.raises(ImportError, match="use render_trajectory"):
        interactive_recon(params, *args, {}, device="cpu")
    with pytest.raises(ImportError, match="use online_replay"):
        interactive_online_recon(params, variables["timestep"], *args, {},
                                 device="cpu")


def test_eval_novel_view_cli_train_split(scene):
    """``python -m splatam_torch.run.eval_novel_view`` on the train split:
    eval_sequence with the rendered frames saved under eval_train."""
    results = eval_novel_view.main([scene["exp"], "--device", "cpu"])
    out = scene["run"] / "eval_train"
    assert results["frames"] == FRAMES
    for sub in ("rendered_rgb", "rendered_depth"):
        assert sorted(os.listdir(out / sub)) == [
            f"gs_{t:04d}.png" for t in range(FRAMES)]
    np.testing.assert_allclose(np.loadtxt(out / "psnr.txt"),
                               np.loadtxt(scene["run"] / "eval" / "psnr.txt"),
                               rtol=1e-6)


def test_eval_nvs_matches_jax(scene, monkeypatch):
    """``python -m splatam_torch.run.eval_novel_view`` on the Replica-V2 test
    split (eval_nvs of a tracking-only run: the silhouette's pixels only)
    against the JAX package's eval_nvs on the same map and files: every
    result and every nvs_*.txt within 1e-4; then the same views without
    the silhouette mask, which can only lower the PSNR."""
    import jax

    from splatam_tpu.data import get_dataset as jget_dataset
    from splatam_tpu.data import load_dataset_config as jload_data_cfg
    from splatam_tpu.eval import nvs as jnvs
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.run.common import load_experiment_config as jload_config
    from splatam_tpu.utils.checkpoint import load_params as jload_params

    from splatam_torch.eval.nvs import eval_nvs
    from splatam_torch.run.common import build_dataset, load_experiment_config

    results = eval_novel_view.main([scene["nvs"], "--device", "cpu"])
    out = scene["run"] / "eval_nvs"
    config = jload_config(scene["nvs"])
    d = config["data"]
    jds = jget_dataset(jload_data_cfg(d["gradslam_data_cfg"]), d["basedir"],
                       d["sequence"], desired_height=H, desired_width=W,
                       use_train_split=False)
    assert len(jds) == 3  # the first train frame, then the 2 test views
    jparams, jvars, _ = jload_params(str(scene["run"] / "params.npz"))
    jout = out.parent / "jax_nvs"
    # the JAX metrics under jax.jit (one compile each, not one per op)
    monkeypatch.setattr(jnvs, "psnr", jax.jit(jnvs.psnr))
    monkeypatch.setattr(jnvs, "ms_ssim", jax.jit(jnvs.ms_ssim))
    ref = jnvs.eval_nvs(jds, jparams, jvars["active"], len(jds), str(jout),
                        sil_thres=0.5, mapping_iters=0,
                        add_new_gaussians=False,
                        raster_cfg=JCfg(**config["raster"]))
    assert results.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(results[key], ref[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    for name in ("psnr", "rmse", "l1", "ssim", "lpips", "valid"):
        np.testing.assert_allclose(np.loadtxt(out / f"nvs_{name}.txt"),
                                   np.loadtxt(jout / f"nvs_{name}.txt"),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert np.isfinite(results["psnr"]) and results["psnr"] > 10.0

    port_cfg = load_experiment_config(scene["nvs"])
    unmasked = eval_nvs(build_dataset(port_cfg, use_train_split=False),
                        scene["state"].params, 3, str(out.parent / "unmasked"),
                        sil_thres=0.5, mapping_iters=10, add_new_gaussians=True,
                        device="cpu")
    assert unmasked["psnr"] <= results["psnr"]


def test_save_frames_without_imageio(tmp_path, monkeypatch):
    """The evaluation's frame writer with imageio absent (as on a host that
    has Pillow only): the 8-bit RGB and 16-bit depth PNGs read back equal to
    the ones imageio writes; with neither library it raises, naming both."""
    import imageio.v2 as imageio

    from splatam_torch.data import base
    from splatam_torch.eval.runner import _save_frames

    rng = np.random.default_rng(0)
    im = rng.uniform(-0.1, 1.1, (3, H, W)).astype(np.float32)
    depth = rng.uniform(0, 5, (1, H, W)).astype(np.float32)
    _save_frames(str(tmp_path / "imageio"), 3, im, depth)
    monkeypatch.setattr(base, "IMREAD_DECODER", "PIL")
    for name in ("imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)  # import raises
    _save_frames(str(tmp_path / "pil"), 3, im, depth)
    monkeypatch.undo()
    for sub, dtype in (("rendered_rgb", np.uint8), ("rendered_depth", np.uint16)):
        ref = imageio.imread(tmp_path / "imageio" / sub / "gs_0003.png")
        got = imageio.imread(tmp_path / "pil" / sub / "gs_0003.png")
        assert ref.dtype == got.dtype == dtype
        np.testing.assert_array_equal(got, ref)
    monkeypatch.setattr(base, "IMREAD_DECODER", None)
    shutil.rmtree(tmp_path / "pil")
    with pytest.raises(ImportError, match="neither imageio nor Pillow"):
        _save_frames(str(tmp_path / "pil"), 3, im, depth)
