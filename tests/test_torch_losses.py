"""Port losses and Adam against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatam_torch.core.losses import calc_ssim, slam_loss
from splatam_torch.core.optim import adam_step, init_adam
from splatam_torch.core.params import GAUSSIAN_KEYS
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)


def _problem(seed=9, n=150, w=72, h=56):
    """A small scene (anisotropic, so rotation gradients are real) and a
    random ground-truth frame; h % 16 != 0 exercises the pad pixels."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(0.5, 5.0, n)], -1)
    opac = 1 / (1 + np.exp(-rng.uniform(-2, 3.0, n)))
    params = {
        "means3D": means,
        "rgb_colors": rng.uniform(0, 1, (n, 3)),
        "unnorm_rotations": rng.normal(0, 1, (n, 4)),
        "logit_opacities": np.log(opac / (1 - opac)).reshape(-1, 1),
        "log_scales": rng.uniform(-3.5, -1.5, (n, 3)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    gt_im = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    gt_depth = (rng.uniform(0.5, 4.0, (1, h, w))
                * (rng.uniform(size=(1, h, w)) > 0.1)).astype(np.float32)
    k = [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]]
    return params, gt_im, gt_depth, w, h, k


@pytest.mark.parametrize(
    "tracking,use_sil,ignore_outlier",
    [(True, True, True), (False, False, False)],
    ids=["tracking", "mapping"],
)
def test_slam_loss_matches_jax(tracking, use_sil, ignore_outlier):
    from splatam_tpu.core.losses import slam_loss as jslam_loss
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.camera import setup_camera as jsetup

    params, gt_im, gt_depth, w, h, k = _problem()
    kw = dict(tracking=tracking, loss_w_im=0.5, loss_w_depth=1.0,
              use_sil_for_loss=use_sil, sil_thres=0.5,
              ignore_outlier_depth_loss=ignore_outlier)
    rot = np.array([1, 0, 0, 0], np.float32)
    # a pose a little off identity, so the tracking gradient is generic
    rot = rot + np.array([0.0, 0.01, -0.005, 0.003], np.float32)
    tran = np.array([0.01, -0.02, 0.015], np.float32)

    jcam = jsetup(w, h, k, np.eye(4))
    jcfg = JCfg(max_instances=2**15, max_per_tile=1024, chunk=128,
                backend="jnp")
    active = jnp.ones(params["means3D"].shape[0], bool)

    def jf(gauss, r, t):
        return jslam_loss(gauss, active, r, t, gt_im, gt_depth, jcam, jcfg,
                          **kw).loss

    argnums = (1, 2) if tracking else (0,)
    jloss, jg = jax.jit(jax.value_and_grad(jf, argnums=argnums))(
        params, rot, tran
    )

    cam = setup_camera(w, h, k, np.eye(4), device="cpu")
    tp = {key: torch.tensor(v, requires_grad=not tracking)
          for key, v in params.items()}
    tr = torch.tensor(rot, requires_grad=tracking)
    tt = torch.tensor(tran, requires_grad=tracking)
    out = slam_loss(tp, tr, tt, torch.tensor(gt_im), torch.tensor(gt_depth),
                    cam, RasterConfig(chunk=128), **kw)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jloss), rtol=2e-5)
    if tracking:
        pairs = [(tr.grad, jg[0]), (tt.grad, jg[1])]
    else:
        pairs = [(tp[key].grad, jg[0][key]) for key in GAUSSIAN_KEYS]
    for mine, ref in pairs:
        ref = np.asarray(ref)
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(mine.numpy() / scale, ref / scale,
                                   atol=5e-5)


def test_ssim_matches_jax():
    from splatam_tpu.core.losses import calc_ssim as jssim

    rng = np.random.default_rng(3)
    a = rng.random((3, 40, 56), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    np.testing.assert_allclose(
        float(calc_ssim(torch.tensor(a), torch.tensor(b))),
        float(jax.jit(jssim)(a, b)), atol=1e-5,
    )


def test_adam_steps_match_jax():
    """Three steps with two learning rates, and a skipped (non-finite)
    step that must leave parameters, moments and step count alone."""
    from splatam_tpu.core.optim import adam_step as jadam
    from splatam_tpu.core.optim import init_adam as jinit

    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    lrs = {"a": 1e-2, "b": 3e-3}
    jp, js = dict(p0), jinit(p0)
    tp = {key: torch.tensor(v) for key, v in p0.items()}
    ts = init_adam(tp)
    for i in range(3):
        g = {key: rng.normal(size=v.shape).astype(np.float32)
             for key, v in p0.items()}
        jp, js = jadam(jp, g, js, lrs, eps=1e-15)
        adam_step(tp, {key: torch.tensor(v) for key, v in g.items()}, ts, lrs,
                  eps=1e-15)
        if i == 1:
            adam_step(tp, {key: torch.full_like(v, float("nan"))
                           for key, v in tp.items()}, ts, lrs, eps=1e-15,
                      apply=torch.tensor(False))
    assert int(ts.step) == int(js.step) == 3
    for key in p0:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.nu[key].numpy(), np.asarray(js.nu[key]),
                                   rtol=1e-6, atol=1e-9)


def test_count_instances_matches_jax():
    from splatam_tpu.core.losses import count_instances as jcount
    from splatam_tpu.render.camera import setup_camera as jsetup

    from splatam_torch.core.losses import count_instances

    params, _, _, w, h, k = _problem()
    rot = np.array([1, 0.01, -0.005, 0.003], np.float32)
    tran = np.array([0.01, -0.02, 0.015], np.float32)
    active = jnp.ones(params["means3D"].shape[0], bool)
    ref = int(jcount(params, active, rot, tran, jsetup(w, h, k, np.eye(4))))
    got = count_instances({key: torch.tensor(v) for key, v in params.items()},
                          torch.tensor(rot), torch.tensor(tran),
                          setup_camera(w, h, k, np.eye(4), device="cpu"))
    assert got == ref > 0


def test_adam_state_surgery_matches_jax():
    """Appended rows start with zero moments (JAX: zero_state_slots on the
    new slots), pruned rows take theirs away (JAX: the slots leave the
    active set), and a replaced parameter restarts at zero."""
    from splatam_tpu.core.optim import AdamState as JState
    from splatam_tpu.core.optim import reset_param_state as jreset
    from splatam_tpu.core.optim import zero_state_slots as jzero

    from splatam_torch.core.optim import (
        cat_state_zeros,
        prune_state,
        reset_param_state,
    )

    rng = np.random.default_rng(1)
    cap, n, m = 8, 5, 2
    mu = {k: rng.normal(size=(cap, 3)).astype(np.float32) for k in ("a", "b")}
    nu = {k: rng.random((cap, 3)).astype(np.float32) for k in ("a", "b")}
    js = jzero(JState(mu=mu, nu=nu, step=jnp.asarray(3.0)), ("a",), n, n + m)
    ts = init_adam({k: torch.zeros(n, 3) for k in ("a", "b")})
    for k in ("a", "b"):
        ts.mu[k], ts.nu[k] = torch.tensor(mu[k][:n]), torch.tensor(nu[k][:n])
    cat_state_zeros(ts, ("a",), m)
    np.testing.assert_array_equal(ts.mu["a"].numpy(), np.asarray(js.mu["a"])[:n + m])
    np.testing.assert_array_equal(ts.nu["a"].numpy(), np.asarray(js.nu["a"])[:n + m])

    keep = np.array([True, False, True, True, False, True, True])
    prune_state(ts, ("a",), torch.tensor(keep))
    np.testing.assert_array_equal(ts.mu["a"].numpy(),
                                  np.asarray(js.mu["a"])[:n + m][keep])

    js = jreset(js, "b")
    reset_param_state(ts, "b")
    np.testing.assert_array_equal(ts.mu["b"].numpy(), np.asarray(js.mu["b"])[:n])
    np.testing.assert_array_equal(ts.nu["b"].numpy(), np.asarray(js.nu["b"])[:n])
