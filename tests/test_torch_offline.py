"""Offline 3DGS training, post-SLAM refinement and their modules (Inria
densification, LR schedule, Adam surgery, metrics, checkpoints, PLY)
against the JAX package.

Both packages train on the same frames (the port's synthetic sequence at
the 64x48, chunk-32 setting of tests/test_offline_gs.py::_config), the JAX
side at ``backend="jnp"``; the JAX run is made once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatam_torch.core.optim import AdamState, init_adam, reset_param_state, zero_state_slots
from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose, params_from_numpy
from splatam_torch.data.synthetic import SyntheticDataset
from splatam_torch.eval import metrics
from splatam_torch.gs.offline import gs_step, offline_splatting
from splatam_torch.gs.post_opt import post_splatam_opt
from splatam_torch.render.binning import RasterConfig
from splatam_torch.slam.inria_densify import densify, get_expon_lr_func
from splatam_torch.slam.pipeline import as_frame
from splatam_torch.utils import checkpoint, ply

from tests.test_offline_gs import _config

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

FRAMES, W, H = 4, 64, 48
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def runs():
    """The same offline training in both packages, on the same frames."""
    from splatam_tpu.gs.offline import offline_splatting as joffline

    ds = SyntheticDataset(num_frames=FRAMES, width=W, height=H, seed=0,
                          device="cpu")
    frames = [ds[t] for t in range(FRAMES)]
    jstate = joffline(_config(FRAMES, 30), frames, progress=False)
    state = offline_splatting(_config(FRAMES, 30), frames, progress=False,
                              device="cpu")
    return frames, jstate, state


def _jax_map(jstate):
    """The JAX map's live Gaussians and trajectory as port tensors."""
    return params_from_numpy({k: np.asarray(v) for k, v in jstate.params.items()},
                             {k: np.asarray(v) for k, v in jstate.variables.items()},
                             device="cpu")


def _render(params, t, cam, cfg=None):
    from splatam_torch.core.losses import render_for_loss

    cfg = cfg or RasterConfig(**_config(FRAMES, 0)["raster"])
    out, _ = render_for_loss({k: params[k] for k in GAUSSIAN_KEYS},
                             *get_pose(params, t), cam, cfg,
                             gaussians_grad=False, camera_grad=False)
    return out


def _psnrs(params, frames, cam):
    return [float(metrics.psnr(_render(params, t, cam).color[:3],
                               as_frame(c, d, CPU)[0]))
            for t, (c, d, _, _) in enumerate(frames)]


def test_offline_splatting_matches_jax(runs):
    """Whole runs of the slice: final Gaussian counts within 1%, per-frame
    PSNR of the two maps (rendered by the port) within 0.5 dB."""
    frames, jstate, state = runs
    n_jax = int(np.asarray(jstate.variables["active"]).sum())
    n = state.params["means3D"].shape[0]
    assert abs(n - n_jax) <= 0.01 * n_jax
    assert state.counts["offline_iters"] == 30
    jparams, _ = _jax_map(jstate)
    mine, ref = _psnrs(state.params, frames, state.cam), _psnrs(
        jparams, frames, state.cam)
    np.testing.assert_allclose(mine, ref, atol=0.5)
    assert min(mine) > 18.0


def test_gs_step_matches_jax(runs):
    """One step from the same map and frame: the loss, the gradients (as
    the first Adam moments), the updated parameters and the means2d_dummy
    gradient norm."""
    from splatam_tpu.core.optim import init_adam as jinit_adam
    from splatam_tpu.core.params import get_pose as jget_pose
    from splatam_tpu.gs.offline import gs_step as jgs_step
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.slam.pipeline import _as_frame

    frames, jstate, state = runs
    config = _config(FRAMES, 30)
    lrs = config["train"]["lrs_mapping"]
    color, depth, _, _ = frames[1]
    gauss = {k: jstate.params[k] for k in GAUSSIAN_KEYS}
    active = np.asarray(jstate.variables["active"])
    rot, tran = jget_pose(jstate.params, 1)
    jres = jgs_step(
        gauss, jstate.variables["active"], jinit_adam(gauss), rot, tran,
        *_as_frame(color, depth), jstate.cam, JCfg(**config["raster"]),
        tuple(GAUSSIAN_KEYS), jnp.asarray([lrs[k] for k in GAUSSIAN_KEYS],
                                          jnp.float32),
        loss_w_im=0.5, loss_w_depth=1.0,
    )

    params, _ = _jax_map(jstate)
    opt = init_adam({k: params[k] for k in GAUSSIAN_KEYS})
    res = gs_step(params, opt, *get_pose(params, 1), *as_frame(color, depth, CPU),
                  state.cam, RasterConfig(**config["raster"]), lrs)
    np.testing.assert_allclose(float(res.losses["loss"]),
                               float(jres.losses["loss"]), rtol=2e-5)
    for k in GAUSSIAN_KEYS:
        ref = np.asarray(jres.opt_state.mu[k])[active]
        scale = np.abs(ref).max() + 1e-20
        np.testing.assert_allclose(opt.mu[k].numpy() / scale, ref / scale,
                                   atol=5e-5, err_msg=k)
        # one Adam step moves each entry by -lr sign(g): a sign that flips
        # on a gradient near zero moves it by 2 lr instead
        new, jnew = params[k].numpy(), np.asarray(jres.params[k])[active]
        np.testing.assert_allclose(new, jnew, atol=2.0001 * lrs[k], err_msg=k)
        assert np.mean(np.abs(new - jnew) > 1e-6) < 0.01, k
    ref = np.asarray(jres.means2d_grad_norm)[active]
    np.testing.assert_allclose(res.means2d_grad_norm.numpy() / ref.max(),
                               ref / ref.max(), atol=5e-5)
    np.testing.assert_array_equal(res.seen.numpy(),
                                  np.asarray(jres.seen)[active])


def _densify_inputs():
    """A map where clone, split, opacity pruning, big-Gaussian pruning and
    the opacity reset all happen, in the JAX package's padded layout."""
    from splatam_tpu.core.params import initialize_params

    rng = np.random.default_rng(0)
    m = 120
    pt_cld = np.concatenate([rng.normal(size=(m, 3)),
                             rng.uniform(0, 1, (m, 3))], -1).astype(np.float32)
    params, variables = initialize_params(
        pt_cld, 1, rng.uniform(1e-6, 1e-3, m), "anisotropic", capacity=256)
    params = {k: np.array(v) for k, v in params.items()}
    variables = {k: np.array(v) for k, v in variables.items()}
    params["log_scales"][:m] = np.log(
        np.exp(rng.uniform(np.log(0.002), np.log(0.15), (m, 1)))
        * rng.uniform(0.5, 1.0, (m, 3)))
    params["logit_opacities"][:m] = rng.normal(0, 3, (m, 1))
    params["unnorm_rotations"][:m] = rng.normal(size=(m, 4))
    variables["means2D_gradient_accum"][:m] = rng.uniform(0, 2, m)
    variables["denom"][:m] = rng.integers(0, 3, m)
    variables["timestep"][:m] = rng.integers(0, 5, m)
    moments = {k: (rng.normal(size=v.shape).astype(np.float32),
                   rng.uniform(0, 1, v.shape).astype(np.float32))
               for k, v in params.items() if k in GAUSSIAN_KEYS}
    dd = {
        "start_after": 0, "stop_after": 100, "densify_every": 3,
        "grad_thresh": 1.0, "num_to_split_into": 2,
        "removal_opacity_threshold": 0.005,
        "final_removal_opacity_threshold": 0.005,
        "reset_opacities": True, "reset_opacities_every": 6,
        "remove_big_after": 6,
    }
    return params, variables, moments, dd


def test_densify_matches_jax():
    """The same inputs and numpy seed give the same clone, split and prune
    sets and the same new Gaussians (the JAX map's live slots in slot
    order), moments carried for survivors and zero for new Gaussians."""
    from splatam_tpu.core.optim import AdamState as JAdam
    from splatam_tpu.slam.inria_densify import densify as jdensify

    params, variables, moments, dd = _densify_inputs()
    jopt = JAdam(mu={k: jnp.asarray(v[0]) for k, v in moments.items()},
                 nu={k: jnp.asarray(v[1]) for k, v in moments.items()},
                 step=jnp.asarray(3, jnp.int32))
    jp, jv, jopt = jdensify({k: jnp.asarray(v) for k, v in params.items()},
                            {k: jnp.asarray(v) for k, v in variables.items()},
                            jopt, 6, dd, 1.0, np.random.default_rng(0))
    active = np.asarray(jv["active"])

    tp, tv = params_from_numpy(params, variables, device="cpu")
    live = variables["active"]
    opt = AdamState(mu={k: torch.tensor(v[0][live]) for k, v in moments.items()},
                    nu={k: torch.tensor(v[1][live]) for k, v in moments.items()},
                    step=torch.tensor(3.0))
    grads = tv["means2D_gradient_accum"] / tv["denom"].clamp(min=1)
    big = torch.exp(tp["log_scales"]).max(dim=1).values
    hot = (grads >= dd["grad_thresh"]) & (tv["denom"] > 0)
    # every set is populated: clones, splits, opacity and size pruning
    assert (hot & (big <= 0.01)).any() and (hot & (big > 0.01)).any()
    assert (torch.sigmoid(tp["logit_opacities"]) < 0.005).any()
    assert ((big > 0.1) & ~hot).any()
    tp, tv, opt = densify(tp, tv, opt, 6, dd, 1.0, np.random.default_rng(0))
    assert tp["means3D"].shape[0] == active.sum()
    for k in GAUSSIAN_KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k])[active],
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        for mine, ref in ((opt.mu[k], jopt.mu[k]), (opt.nu[k], jopt.nu[k])):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref)[active],
                                       atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tv["timestep"].numpy(),
                                  np.asarray(jv["timestep"])[active])
    for k in ("means2D_gradient_accum", "denom", "max_2D_radius"):
        assert not tv[k].any()


def test_adam_surgery_matches_jax():
    """zero_state_slots and reset_param_state against the JAX package's."""
    from splatam_tpu.core.optim import AdamState as JAdam
    from splatam_tpu.core.optim import reset_param_state as jreset
    from splatam_tpu.core.optim import zero_state_slots as jzero

    rng = np.random.default_rng(2)
    shapes = {"means3D": (300, 3), "logit_opacities": (300, 1)}
    mu = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    nu = {k: rng.uniform(size=s).astype(np.float32) for k, s in shapes.items()}
    jst = JAdam(mu={k: jnp.asarray(v) for k, v in mu.items()},
                nu={k: jnp.asarray(v) for k, v in nu.items()},
                step=jnp.asarray(1, jnp.int32))
    st = AdamState(mu={k: torch.tensor(v) for k, v in mu.items()},
                   nu={k: torch.tensor(v) for k, v in nu.items()},
                   step=torch.tensor(1.0))
    jst = jreset(jzero(jst, ["means3D"], 100, 150), "logit_opacities")
    zero_state_slots(st, ["means3D"], 100, 150)
    reset_param_state(st, "logit_opacities")
    for k in shapes:
        # JAX zeroes whole append quanta past ``stop``: compare to it
        np.testing.assert_array_equal(st.mu[k].numpy()[:150],
                                      np.asarray(jst.mu[k])[:150])
        np.testing.assert_array_equal(st.nu[k].numpy()[:150],
                                      np.asarray(jst.nu[k])[:150])
    assert not st.mu["means3D"][100:150].any()
    np.testing.assert_array_equal(st.mu["means3D"][150:].numpy(),
                                  mu["means3D"][150:])


@pytest.mark.parametrize("kw", [
    dict(lr_init=1e-2, lr_final=1e-4, max_steps=100),
    dict(lr_init=3.2e-4, lr_final=3.2e-6, lr_delay_mult=0.01, max_steps=500),
    dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=50, lr_delay_mult=0.1,
         max_steps=200),
])
def test_expon_lr_matches_jax(kw):
    from splatam_tpu.slam.inria_densify import get_expon_lr_func as jget

    mine, ref = get_expon_lr_func(**kw), jget(**kw)
    for step in (-1, 0, 1, 25, 50, 100, 199, 200, 500, 900):
        assert mine(step) == ref(step)


@pytest.mark.parametrize("shape", [(3, 48, 64), (3, 176, 192)])
def test_metrics_match_jax(shape):
    """psnr, ssim and ms_ssim (3 scales at 48x64, all 5 at 176x192)."""
    from splatam_tpu.eval import metrics as jm

    rng = np.random.default_rng(3)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    ref = jax.jit(lambda x, y: (jm.psnr(x, y), jm.ssim(x, y),
                                jm.ms_ssim(x, y)))(a, b)
    ta, tb = torch.tensor(a), torch.tensor(b)
    mine = (metrics.psnr(ta, tb), metrics.ssim(ta, tb), metrics.ms_ssim(ta, tb))
    np.testing.assert_allclose([float(x) for x in mine],
                               [float(x) for x in ref], atol=1e-5, rtol=1e-5)


def test_checkpoints_interchange_with_jax(runs, tmp_path):
    """A params.npz written by either package has the same members and
    types as the other's, and loads into the other: the map read back
    renders as the writer's own map does (the renders of the two packages
    are held together by test_torch_split.py)."""
    from splatam_tpu.utils import checkpoint as jck

    frames, jstate, state = runs
    extras = dict(intrinsics=state.intrinsics, first_w2c=state.first_w2c,
                  gt_w2c_all_frames=state.gt_w2c_all,
                  keyframe_time_indices=[0, 2], org_width=W, org_height=H)
    jck.save_params(jstate.params, jstate.variables, str(tmp_path / "jax"),
                    **extras)
    path = checkpoint.save_params(state.params, state.variables,
                                  str(tmp_path / "port"), **extras)
    jz, tz = np.load(tmp_path / "jax" / "params.npz"), np.load(path)
    assert sorted(jz.files) == sorted(tz.files)
    for key in jz.files:
        assert jz[key].dtype == tz[key].dtype, key
        assert jz[key].shape[1:] == tz[key].shape[1:], key

    # JAX -> port: the loaded map renders as the JAX map converted in memory
    jparams, _ = _jax_map(jstate)
    params, variables, extras_back = checkpoint.load_params(
        str(tmp_path / "jax" / "params.npz"), device="cpu")
    assert set(extras_back) == set(checkpoint.EXTRA_KEYS)
    np.testing.assert_array_equal(variables["timestep"].numpy(),
                                  jz["timestep"])
    assert torch.equal(_render(params, 1, state.cam).color,
                       _render(jparams, 1, state.cam).color)
    # port -> JAX: the map JAX loads renders as the port's own map
    jp, jv, _ = jck.load_params(path)
    back, _ = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                {k: np.asarray(v) for k, v in jv.items()},
                                device="cpu")
    for k in state.params:
        assert torch.equal(back[k], state.params[k]), k
    assert torch.equal(_render(back, 1, state.cam).color,
                       _render(state.params, 1, state.cam).color)


def test_post_splatam_opt_keeps_poses(runs):
    """Refinement from a checkpoint keeps the estimated trajectory and the
    map's size (densification starts later), and does not make the map
    worse."""
    frames, _, state = runs
    ckpt = checkpoint.params_to_numpy(state.params, state.variables)
    refined = post_splatam_opt(_config(FRAMES, 5), frames, ckpt,
                               progress=False, device="cpu")
    for k in ("cam_unnorm_rots", "cam_trans"):
        np.testing.assert_allclose(refined.params[k].numpy(), ckpt[k],
                                   atol=1e-6)
    assert refined.params["means3D"].shape[0] == ckpt["means3D"].shape[0]
    before = _psnrs(state.params, frames[:2], state.cam)
    after = _psnrs(refined.params, frames[:2], state.cam)
    assert np.mean(after) > np.mean(before) - 0.5


def test_ply_interchange_with_jax(tmp_path):
    """A PLY written by one package is read back by the other."""
    from splatam_tpu.utils import ply as jply

    rng = np.random.default_rng(0)
    params = {
        "means3D": rng.normal(size=(20, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0, 1, (20, 3)).astype(np.float32),
        "log_scales": rng.normal(size=(20, 1)).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(20, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(20, 1)).astype(np.float32),
    }
    ply.save_ply_from_params(str(tmp_path / "port.ply"),
                             {k: torch.tensor(v) for k, v in params.items()})
    jply.save_ply_from_params(str(tmp_path / "jax.ply"), params)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for mine, ref in ((ply.load_ply(str(tmp_path / "jax.ply")),
                       jply.load_ply(str(tmp_path / "jax.ply"))),
                      (jply.load_ply(str(tmp_path / "port.ply")),
                       ply.load_ply(str(tmp_path / "port.ply")))):
        for k, v in ref.items():
            np.testing.assert_array_equal(mine[k], v)
    back = jply.load_ply(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(back["means3D"], params["means3D"], atol=1e-6)
    np.testing.assert_allclose(back["log_scales"],
                               np.tile(params["log_scales"], (1, 3)), atol=1e-6)
