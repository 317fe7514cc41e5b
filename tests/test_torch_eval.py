"""The port's evaluation (eval/runner, eval/report, eval/lpips) against the
JAX package's, and the SSIM window cache. The JAX references run once per
module, their renders under jax.jit (the jnp backend)."""
import os

import numpy as np
import pytest
import torch

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

W, H, FRAMES = 64, 48, 3
SIL = 0.5
RTOL = 1e-4
JAX_CFG = dict(max_instances=2**16, max_per_tile=4096, chunk=128, backend="jnp")


def _map_and_frames():
    """A map (the synthetic scene, colors off by a few percent), a
    trajectory 1-2 mm off the ground truth, and the port's synthetic frames
    at 64x48."""
    from splatam_torch.core.transforms import matrix_to_quaternion
    from splatam_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=FRAMES, width=W, height=H, seed=0,
                          device="cpu")
    frames = [ds[t] for t in range(FRAMES)]
    rng = np.random.default_rng(7)
    n = ds.means.shape[0]
    params = {
        "means3D": ds.means,
        "rgb_colors": np.clip(ds.colors + rng.normal(0, 0.03, ds.colors.shape),
                              0, 1),
        "unnorm_rotations": ds.quats,
        "logit_opacities": np.log(ds.opac / (1 - ds.opac))[:, None],
        "log_scales": np.log(ds.scales[:, :1]),
    }
    rots, trans = [], []
    for t in range(FRAMES):
        w2c = np.linalg.inv(frames[t][3].astype(np.float64))
        rots.append(matrix_to_quaternion(torch.tensor(w2c[:3, :3],
                                                      dtype=torch.float32)).numpy())
        trans.append(w2c[:3, 3] + (rng.normal(0, 1e-3, 3) if t else 0))
    params["cam_unnorm_rots"] = np.stack(rots, -1)[None]
    params["cam_trans"] = np.stack(trans, -1)[None]
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    return frames, params, n


@pytest.fixture(scope="module")
def jrender():
    """JAX's render_for_loss at JAX_CFG, jitted once for the module: its
    eval_sequence would jit a render of its own on every call, and its
    report_progress and eval_online render eagerly."""
    import jax

    from splatam_tpu.core.losses import render_for_loss
    from splatam_tpu.render.binning import RasterConfig as JCfg

    jitted = jax.jit(lambda p, a, r, tr, c: render_for_loss(
        p, a, r, tr, c, JCfg(**JAX_CFG), gaussians_grad=False,
        camera_grad=False))
    return lambda p, a, r, tr, c, cfg, **kw: jitted(p, a, r, tr, c)


class _JaxRenderJitted:
    """``jax`` for the JAX eval runner, whose ``jax.jit`` (it jits only its
    render) hands back the module's compiled render."""

    def __init__(self, render):
        self.render = render

    def __getattr__(self, name):
        import jax

        return getattr(jax, name)

    def jit(self, fun, **kwargs):
        return lambda p, a, r, t, c: self.render(p, a, r, t, c, None)[0]


@pytest.fixture(scope="module")
def scene(tmp_path_factory, jrender):
    """The JAX eval_sequence on the map: every frame, and tracking-only.
    Its render and metrics run under jax.jit (eagerly each op compiles on
    its own)."""
    import jax
    import jax.numpy as jnp

    from splatam_tpu.eval import runner as jrunner
    from splatam_tpu.render.binning import RasterConfig as JCfg

    frames, params, n = _map_and_frames()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    active = jnp.ones(n, bool)
    root = tmp_path_factory.mktemp("eval")
    jax_runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "psnr", jax.jit(jrunner.psnr))
        mp.setattr(jrunner, "ms_ssim", jax.jit(jrunner.ms_ssim))
        mp.setattr(jrunner, "jax", _JaxRenderJitted(jrender))
        for mode, (iters, add) in {"mapped": (30, True),
                                   "tracking_only": (0, False)}.items():
            d = str(root / f"jax_{mode}")
            res = jrunner.eval_sequence(
                frames, jparams, active, FRAMES, d, SIL, iters, add,
                eval_every=1, raster_cfg=JCfg(**JAX_CFG))
            jax_runs[mode] = (res, d)
    return frames, params, jax_runs, root


def _read(d, name):
    return np.atleast_1d(np.loadtxt(os.path.join(d, f"{name}.txt")))


@pytest.mark.parametrize("mode,every,layout", [
    ("mapped", 1, "aligned"), ("mapped", 2, "split"),
    ("tracking_only", 1, "split")])
def test_eval_sequence_matches_jax(scene, mode, every, layout):
    """Per-frame PSNR, MS-SSIM, depth L1 and the reference's 'RMSE' to
    1e-4 relative, the same files, and the same ATE."""
    from splatam_torch.core.params import params_from_numpy
    from splatam_torch.eval.runner import eval_sequence
    from splatam_torch.render.binning import RasterConfig

    frames, params, jax_runs, root = scene
    jres, jdir = jax_runs[mode]
    tparams, _ = params_from_numpy(params, device="cpu")
    iters, add = (30, True) if mode == "mapped" else (0, False)
    d = str(root / f"torch_{mode}_{every}")
    res = eval_sequence(frames, tparams, FRAMES, d, SIL, iters, add,
                        eval_every=every,
                        raster_cfg=RasterConfig(chunk=64, layout=layout),
                        device="cpu")
    # eval_every 2 renders frame 0 and every frame t with (t + 1) % 2 == 0
    keep = [t for t in range(FRAMES) if t == 0 or (t + 1) % every == 0]
    assert res["frames"] == len(keep)
    assert sorted(os.listdir(d)) == sorted(os.listdir(jdir))
    for name in ("psnr", "ssim", "l1", "rmse"):
        got, ref = _read(d, name), _read(jdir, name)[keep]
        np.testing.assert_allclose(got, ref, rtol=RTOL, err_msg=name)
    assert np.isnan(_read(d, "lpips")).all()
    np.testing.assert_allclose(res["ate_rmse"], jres["ate_rmse"], rtol=1e-3)
    assert 1e-4 < res["ate_rmse"] < 5e-3
    if every == 1:
        for k in ("psnr", "ms_ssim", "depth_l1", "depth_rmse"):
            np.testing.assert_allclose(res[k], jres[k], rtol=RTOL, err_msg=k)


def test_report_progress_matches_jax(scene, jrender, monkeypatch):
    """report_progress (tracking: silhouette-masked PSNR, depth L1, the
    partial ATE) and partial_trajectory_ate against JAX's."""
    import jax.numpy as jnp

    from splatam_tpu.eval import report as jreport
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.camera import setup_camera as jsetup

    from splatam_torch.core.params import params_from_numpy
    from splatam_torch.eval.report import partial_trajectory_ate, report_progress
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.slam.pipeline import as_frame

    frames, params, _, _ = scene
    t = FRAMES - 1
    gt = [np.linalg.inv(f[3].astype(np.float64)) for f in frames]
    k = frames[0][2][:3, :3]
    monkeypatch.setattr(jreport, "render_for_loss", jrender)
    jparams = {kk: jnp.asarray(v) for kk, v in params.items()}
    color, depth = frames[t][0], frames[t][1]
    jim = jnp.asarray(np.transpose(color, (2, 0, 1)) / 255.0, jnp.float32)
    jd = jnp.asarray(np.transpose(depth, (2, 0, 1)), jnp.float32)
    ref = jreport.report_progress(
        jparams, jnp.ones(params["means3D"].shape[0], bool), jim, jd,
        jsetup(W, H, k, gt[0]), JCfg(**JAX_CFG), t, 0.99, tracking=True,
        gt_w2c_list=gt, first_w2c=gt[0])

    tparams, _ = params_from_numpy(params, device="cpu")
    im, d = as_frame(color, depth, "cpu")
    logged = []
    got = report_progress(
        tparams, im, d, setup_camera(W, H, k, gt[0], device="cpu"),
        RasterConfig(chunk=64), t, 0.99, tracking=True, gt_w2c_list=gt,
        first_w2c=gt[0], log_fn=logged.append)
    assert logged == [got] and set(got) == set(ref) == {"psnr", "depth_l1", "ate"}
    for key in got:
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=key)
    for up_to in (1, 2):
        np.testing.assert_allclose(
            partial_trajectory_ate(tparams, gt, up_to, gt[0]),
            jreport.partial_trajectory_ate(jparams, gt, up_to, gt[0]),
            rtol=1e-5)


def test_eval_online_matches_jax(scene, jrender, monkeypatch, tmp_path):
    """eval_online (each frame rendered with its own map snapshot,
    tracking-only masks) against JAX's: per-frame PSNR, depth RMSE and L1
    to 1e-4 relative, the same files."""
    import jax.numpy as jnp

    from splatam_tpu.eval import runner as jrunner
    from splatam_tpu.render.binning import RasterConfig as JCfg

    from splatam_torch.core.params import params_from_numpy
    from splatam_torch.eval.runner import eval_online
    from splatam_torch.render.binning import RasterConfig

    frames, params, _, _ = scene
    # the snapshots: the map with its colors drifting frame by frame
    snaps = [dict(params, rgb_colors=np.clip(params["rgb_colors"] + 0.02 * t,
                                             0, 1)) for t in range(FRAMES)]
    monkeypatch.setattr(jrunner, "render_for_loss", jrender)
    active = jnp.ones(params["means3D"].shape[0], bool)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ref = jrunner.eval_online(
        frames, [{k: jnp.asarray(v) for k, v in p.items()} for p in snaps],
        [active] * FRAMES, FRAMES, jdir, SIL, 0, False,
        raster_cfg=JCfg(**JAX_CFG))
    got = eval_online(
        frames, [params_from_numpy(p, device="cpu")[0] for p in snaps],
        FRAMES, tdir, SIL, 0, False, raster_cfg=RasterConfig(chunk=64),
        device="cpu")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("psnr", "rmse", "l1"):
        np.testing.assert_allclose(_read(tdir, name), _read(jdir, name),
                                   rtol=RTOL, err_msg=name)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)


def test_lpips_forward_matches_jax(tmp_path):
    """The port's lpips_forward against JAX's, both on the weights
    convert_torch_lpips writes from a random state dict."""
    import jax.numpy as jnp

    from splatam_tpu.eval.lpips import load_lpips as jload
    from tests.test_lpips import _make_state

    from splatam_torch.eval.lpips import convert_torch_lpips, load_lpips

    path = str(tmp_path / "lpips.npz")
    convert_torch_lpips(_make_state(np.random.default_rng(0)), path)
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = float(load_lpips(path, device="cpu")(torch.tensor(a), torch.tensor(b)))
    ref = float(jload(path)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert load_lpips(str(tmp_path / "absent.npz"), device="cpu") is None


def test_ssim_window_cache():
    """The SSIM windows are built once per (size, sigma, channels, device,
    dtype): a cached window equals a fresh build bit for bit, so SSIM and
    MS-SSIM do too, and a second call builds nothing."""
    from splatam_torch.core import losses
    from splatam_torch.eval import metrics

    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(0, 1, (3, 48, 64)), dtype=torch.float32)
    b = torch.tensor(rng.uniform(0, 1, (3, 48, 64)), dtype=torch.float32)
    cpu = torch.device("cpu")
    window_fns = (losses._gauss_window, metrics._gauss_1d, metrics._scale_weights)
    for f in window_fns:
        f.cache_clear()
    fresh = (losses.calc_ssim(a, b), metrics.ssim(a, b), metrics.ms_ssim(a, b))
    misses = [f.cache_info().misses for f in window_fns]
    cached = (losses.calc_ssim(a, b), metrics.ssim(a, b), metrics.ms_ssim(a, b))
    assert [f.cache_info().misses for f in window_fns] == misses == [1, 1, 1]
    for x, y in zip(fresh, cached):
        assert torch.equal(x, y)
    assert torch.equal(losses._gauss_window(11, 1.5, 3, cpu, torch.float32),
                       losses._gauss_window.__wrapped__(11, 1.5, 3, cpu,
                                                        torch.float32))
    assert torch.equal(metrics._gauss_1d(11, 1.5, cpu, torch.float32),
                       metrics._gauss_1d.__wrapped__(11, 1.5, cpu, torch.float32))
