"""The port's spherical harmonics (``render/sh.py``, ``rasterize_tiled``'s
``shs``) and dense oracle (``render/reference.py``) against the JAX
package's, the goldens, and the port's tiled render."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import golden_scenes
from splatam_torch.core.transforms import normalize
from splatam_torch.render import sh
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.reference import rasterize_dense
from splatam_torch.render.render_tiled import rasterize_tiled

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GRAD_TOL = 5e-5  # of scale (tests/test_pallas.py)


def _scaled_close(got, ref, tol, label):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               atol=tol, err_msg=label)


# ---------------------------------------------------------------------------
# Spherical harmonics
# ---------------------------------------------------------------------------


def _sh_inputs(deg, spread):
    """tests/test_sh.py's scene (64 gaussians 3-5 m ahead, the camera off
    the origin); at ``spread`` 1.5 the clamp at 0 bites more often."""
    rng = np.random.default_rng(deg)
    n = 64
    means = (rng.normal(0, 1, (n, 3)) + np.array([0, 0, 4])).astype(np.float32)
    campos = np.array([0.3, -0.2, 0.1], np.float32)
    shs = rng.normal(0, spread, (n, 16, 3)).astype(np.float32)
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    return shs, means, campos, cot


@functools.lru_cache(maxsize=None)
def _jax_sh(spread):
    """JAX's eval_sh and its gradients in the coefficients and the means,
    for degrees 0-3 at one ``spread``, under one jit."""
    from splatam_tpu.render.sh import eval_sh as jeval

    inputs = [_sh_inputs(deg, spread) for deg in range(4)]

    def run(args):
        outs = []
        for deg, (shs, means, campos, cot) in enumerate(args):
            def loss(s, m):
                out = jeval(deg, s, m, campos)
                return jnp.sum(out * cot), out

            outs.append(jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(shs, means))
        return outs

    outs = jax.jit(run)([tuple(jnp.asarray(x) for x in a) for a in inputs])
    return [(np.asarray(out), np.asarray(gs), np.asarray(gm))
            for (_, out), (gs, gm) in outs]


@pytest.mark.parametrize("spread", [0.5, 1.5])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg, spread):
    """Values and the gradients of a random linear functional, in the SH
    coefficients and the means, where the clamp at 0 gates some."""
    shs, means, campos, cot = _sh_inputs(deg, spread)
    jout, gs, gm = _jax_sh(spread)[deg]
    ts, tm = (torch.tensor(x, requires_grad=True) for x in (shs, means))
    out = sh.eval_sh(deg, ts, tm, torch.tensor(campos))
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-6,
                               rtol=1e-5)
    if spread > 1.0:  # the clamp gates a share of the channels
        assert (jout == 0.0).mean() > 0.05
    _scaled_close(ts.grad.numpy(), gs, 1e-5, "shs")
    if deg > 0:  # degree 0 does not depend on the view direction
        _scaled_close(tm.grad.numpy(), gm, 1e-5, "means")


def test_sh_constants_and_dc_roundtrip():
    from splatam_tpu.render import sh as jsh

    for name in ("SH_C0", "SH_C1", "SH_C2", "SH_C3"):
        assert getattr(sh, name) == getattr(jsh, name), name
    assert [sh.num_sh_coeffs(d) for d in range(4)] == [1, 4, 9, 16]
    rgb = np.random.default_rng(0).uniform(0, 1, (10, 3)).astype(np.float32)
    dc = sh.rgb_to_sh_dc(torch.tensor(rgb))
    np.testing.assert_allclose(dc.numpy(),
                               np.asarray(jsh.rgb_to_sh_dc(jnp.asarray(rgb))),
                               rtol=1e-6)
    np.testing.assert_allclose(sh.sh_dc_to_rgb(dc).numpy(), rgb, atol=1e-6)
    with pytest.raises(ValueError):
        sh.eval_sh(4, torch.zeros(1, 25, 3), torch.zeros(1, 3), torch.ones(3))
    with pytest.raises(ValueError):
        sh.eval_sh(3, torch.zeros(1, 9, 3), torch.zeros(1, 3), torch.ones(3))


def _sh_scene():
    """tests/test_sh.py's render scene: 60 gaussians, degree-3 SH, 128x96."""
    rng = np.random.default_rng(4)
    n = 60
    means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.5, 3.0, n)], axis=-1).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    scales = np.full((n, 3), 0.08, np.float32)
    quats = np.tile([1, 0, 0, 0], (n, 1)).astype(np.float32)
    extra = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    cot = rng.normal(size=(5, 96, 128)).astype(np.float32)
    return means, shs, opac, scales, quats, extra, cot


K_SH = [[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]]


@functools.lru_cache(maxsize=None)
def _jax_sh_render():
    """The JAX jnp render of ``_sh_scene`` with shs and 2 extra channels:
    (loss, color) and the gradients in shs and the means, one compile."""
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.camera import setup_camera as jsetup
    from splatam_tpu.render.render_tiled import rasterize_tiled as jrt

    means, shs, opac, scales, quats, extra, cot = _sh_scene()
    jcam = jsetup(128, 96, K_SH, np.eye(4))
    jcfg = JCfg(max_instances=2**13, max_per_tile=256, chunk=128,
                backend="jnp")

    def jloss(s, m):
        out, _ = jrt(m, jnp.asarray(extra), jnp.asarray(opac),
                     jnp.asarray(scales), jnp.asarray(quats), jcam, cfg=jcfg,
                     shs=s, sh_degree=3)
        return jnp.sum(out.color * cot) + jnp.sum(out.final_t), out.color

    (_, color), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(shs),
                                              jnp.asarray(means))
    return np.asarray(color), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("layout", ["aligned", "split"])
def test_rasterize_tiled_shs_matches_jax(layout):
    """rasterize_tiled(shs=, colors=extra channels) through the kernels'
    plain versions against the JAX jnp path: the SH RGB comes first, the
    gradients in the SH coefficients and the means agree."""
    means, shs, opac, scales, quats, extra, cot = _sh_scene()
    jcolor, (gs, gm) = _jax_sh_render()
    cam = setup_camera(128, 96, K_SH, np.eye(4), device="cpu")
    cfg = RasterConfig(chunk=128, layout=layout)
    ts, tm = (torch.tensor(x, requires_grad=True) for x in (shs, means))
    out, _ = rasterize_tiled(tm, extra, opac, scales, quats, cam, cfg=cfg,
                             device="cpu", shs=ts, sh_degree=3)
    ((out.color * torch.tensor(cot)).sum() + out.final_t.sum()).backward()
    np.testing.assert_allclose(out.color.detach().numpy(), jcolor,
                               atol=1e-5, rtol=1e-4)
    assert float(out.color[:3].detach().max()) > 0.05
    _scaled_close(ts.grad.numpy(), gs, GRAD_TOL, "shs")
    _scaled_close(tm.grad.numpy(), gm, GRAD_TOL, "means")
    # colors=None: the SH RGB alone, equal to the SH channels above
    alone, _ = rasterize_tiled(means, None, opac, scales, quats, cam, cfg=cfg,
                               device="cpu", shs=shs, sh_degree=3)
    np.testing.assert_allclose(alone.color.numpy(),
                               out.color[:3].detach().numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# The dense oracle
# ---------------------------------------------------------------------------


def _oracle_scene(kind):
    """tests/test_oracle.py's scenes: make_scene(seed 4, 30 gaussians at
    32x24) and the saturating stack of near-opaque gaussians at 32x32."""
    if kind == "random":
        rng = np.random.default_rng(4)
        n, w, h = 30, 32, 24
        means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                          rng.uniform(0.5, 5.0, n)], axis=-1)
        colors = rng.uniform(0, 1, (n, 3))
        opac = 1 / (1 + np.exp(-rng.uniform(-2, 3.0, n)))
        scales = np.exp(rng.uniform(-3.5, -1.5, (n, 3)))
        quats = rng.normal(0, 1, (n, 4))
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
        k = [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]]
    else:
        rng = np.random.default_rng(2)
        n, w, h = 40, 32, 32
        means = np.stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
                          np.linspace(1, 2, n)], axis=-1)
        colors = rng.uniform(0, 1, (n, 3))
        opac = np.full(n, 0.995)
        scales = np.full((n, 3), 0.1)
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
        k = [[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]]
    arrays = [np.asarray(x, np.float32)
              for x in (means, colors, opac, scales, quats)]
    wts = np.random.default_rng(9).normal(size=(h, w)).astype(np.float32)
    return arrays, (w, h, k), wts


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_oracle_matches_jax(kind):
    """rasterize_dense's outputs and autograd gradients (all five inputs)
    against the JAX oracle's under jax.grad."""
    from splatam_tpu.render.camera import setup_camera as jsetup
    from splatam_tpu.render.reference import rasterize_dense as jdense

    arrays, (w, h, k), wts = _oracle_scene(kind)
    jcam = jsetup(w, h, k, np.eye(4))

    def jloss(*x):
        out = jdense(*x, jcam)
        return (jnp.sum(out.color ** 2) + jnp.sum(out.depth)
                + jnp.sum(out.final_t * wts)), out

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(
            *(jnp.asarray(a) for a in arrays))
    t = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = rasterize_dense(*t, setup_camera(w, h, k, np.eye(4), device="cpu"))
    ((out.color ** 2).sum() + out.depth.sum()
     + (out.final_t * torch.tensor(wts)).sum()).backward()
    np.testing.assert_allclose(out.color.detach().numpy(),
                               np.asarray(jout.color), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_t.detach().numpy(),
                               np.asarray(jout.final_t), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.depth.detach().numpy(),
                               np.asarray(jout.depth), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(out.radius.numpy(), np.asarray(jout.radius))
    if kind == "saturating":
        assert float(out.final_t.detach().min()) < 1e-3  # the hard stop fired
    for x, g, label in zip(t, jg, ("means", "colors", "opac", "scales",
                                   "quats")):
        _scaled_close(x.grad.numpy(), g, GRAD_TOL, label)


@pytest.mark.parametrize("name", ["sparse_iso", "dense_aniso", "overlap_deep"])
def test_oracle_and_tiled_match_goldens(name):
    """The port's oracle against the frozen renders at tests/test_goldens'
    bounds; the port's tiled render, in both layouts, against the port's
    oracle, forward and gradients."""
    means, colors, opac, scales, quats, w, h, k = golden_scenes()[name]
    cam = setup_camera(w, h, k, np.eye(4), device="cpu")
    arrays = (means, colors, opac, scales, quats)
    t = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = rasterize_dense(t[0], t[1], t[2], t[3], normalize(t[4]), cam)
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    np.testing.assert_allclose(out.color.detach().numpy(), g["color"],
                               atol=1e-5)
    np.testing.assert_allclose(out.depth.detach().numpy(), g["depth"],
                               atol=1e-4)
    np.testing.assert_allclose(out.final_t.detach().numpy(), g["final_t"],
                               atol=1e-5)
    np.testing.assert_array_equal(out.radius.numpy(), g["radius"])

    cot = torch.tensor(np.random.default_rng(1).normal(
        size=(3, h, w)).astype(np.float32))
    ((out.color * cot).sum() + out.final_t.sum()).backward()
    for layout in ("aligned", "split"):
        u = [torch.tensor(a, requires_grad=True) for a in arrays]
        tiled, _ = rasterize_tiled(u[0], u[1], u[2], u[3], normalize(u[4]),
                                   cam, cfg=RasterConfig(chunk=64,
                                                         layout=layout),
                                   device="cpu")
        ((tiled.color * cot).sum() + tiled.final_t.sum()).backward()
        np.testing.assert_allclose(tiled.color.detach().numpy(),
                                   out.color.detach().numpy(), atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(tiled.final_t.detach().numpy(),
                                   out.final_t.detach().numpy(), atol=2e-5,
                                   rtol=1e-4)
        # per-pixel against per-tile order: median-depth tie flips aside
        assert (np.abs(tiled.depth.detach().numpy()
                       - out.depth.detach().numpy()) > 1e-3).mean() < 0.01
        for a, b, label in zip(u[:3], t[:3], ("means", "colors", "opac")):
            _scaled_close(a.grad.numpy(), b.grad.numpy(), GRAD_TOL,
                          f"{layout} {label}")
