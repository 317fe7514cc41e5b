"""Port rasterizer (plain versions of kernels B1/B2) against the JAX package.

The JAX side is its plain reference, ``RasterConfig(backend='jnp')`` with
XLA autodiff. Tolerances are those of the JAX suite's own Pallas-vs-jnp
tests (tests/test_pallas.py): forward atol 1e-5 / rtol 1e-4 (final T atol
2e-5), gradients 5e-5 of their scale.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatam_torch.core.transforms import normalize
from splatam_torch.render import raster
from splatam_torch.render.binning import Binned, RasterConfig, bin_gaussians_csr
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.geometry import preprocess
from splatam_torch.render.render_tiled import (
    blocks_to_image,
    rasterize_tiled,
    rasterize_tiled_blocks,
)

from chip_smoke import FAR_UV, small_scene
from tests.test_torch_geometry import NAMES, jax_scenes, torch_scene  # noqa: F401

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = RasterConfig(chunk=128, layout="aligned")  # B1/B2; split: test_torch_split


def _jcfg():
    from splatam_tpu.render.binning import RasterConfig as JCfg

    return JCfg(max_instances=2**14, max_per_tile=1024, chunk=128,
                backend="jnp")


def _jcam(w, h, k):
    from splatam_tpu.render.camera import setup_camera as jsetup

    return jsetup(w, h, k, np.eye(4))


def _scene(kind, seed=3):
    """numpy scene (means, feats, opacities, scales, quats, w, h, k)."""
    if kind in ("far_contention", "threshold"):  # chip_smoke's stress scenes
        return small_scene(kind, seed)
    rng = np.random.default_rng(seed)
    if kind == "saturating":  # opaque fronts: most tiles saturate early
        n, w, h = 400, 64, 48
        means = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.7, 0.7, n),
                          rng.uniform(0.5, 6.0, n)], -1)
        opac = np.full(n, 0.95)
        scales = np.full((n, 3), 0.25)
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
    else:
        n, w, h = 40, 48, 32
        means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                          rng.uniform(0.5, 5.0, n)], -1)
        if kind == "empty":  # everything behind the camera
            means[:, 2] = -means[:, 2]
        opac = 1 / (1 + np.exp(-rng.uniform(-2, 3.0, n)))
        scales = np.exp(rng.uniform(-3.5, -1.5, (n, 3)))
        quats = rng.normal(0, 1, (n, 4))
    feats = rng.uniform(0, 1, (n, 6))
    k = [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]]
    f32 = [np.asarray(x, np.float32) for x in (means, feats, opac, scales, quats)]
    return (*f32, w, h, k)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_goldens_and_jnp(name, jax_scenes):
    from splatam_tpu.render.render_tiled import rasterize_tiled as jrt

    s = jax_scenes[name]
    a, cam = torch_scene(s)
    out, _ = rasterize_tiled(a["means"], a["colors"], a["opac"], a["scales"],
                             a["quats"], cam, cfg=CFG, device="cpu")
    ref, _ = jax.jit(lambda *x: jrt(*x, s["cam"], cfg=_jcfg()))(
        s["means"], s["colors"], s["opac"], s["scales"], s["quats"]
    )
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    for expect in (
        dict(color=ref.color, depth=ref.depth, final_t=ref.final_t),
        dict(color=g["color"], depth=g["depth"], final_t=g["final_t"]),
    ):
        np.testing.assert_allclose(out.color.numpy(), np.asarray(expect["color"]),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(out.final_t.numpy(),
                                   np.asarray(expect["final_t"]),
                                   atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-5, rtol=1e-4)
    # the dense goldens sort per pixel, the tiles per tile: median-depth
    # tie flips aside, depth agrees (the bound of tests/test_goldens.py)
    dd = np.abs(out.depth.numpy() - g["depth"])
    assert (dd > 1e-3).mean() < 0.01
    np.testing.assert_array_equal(out.radius.numpy(), g["radius"])


GRAD_CASES = ["plain", "saturating", "narrowed", "empty", "far_contention",
              "threshold"]
WIDE = ("saturating", "narrowed", "far_contention", "threshold")  # 400
# gaussians at 64 x 48, 6 channels: one JAX compile


@functools.lru_cache(maxsize=None)
def _jax_grad(w, h):
    """jax.grad of sum(color * cot) + sum(final_t) + w_depth * sum(depth)
    through the jnp path, with the color and final T beside it, one compile
    per image size: cases of one scene size share it, with the cotangent
    and depth weight as arguments."""
    from splatam_tpu.render.render_tiled import rasterize_tiled as jrt

    jcam = _jcam(w, h, [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]])

    def jloss(means, feats, opac, scales, quats, cot, w_depth):
        out, _ = jrt(means, feats, opac, scales, quats, jcam, cfg=_jcfg())
        loss = (jnp.sum(out.color * cot) + jnp.sum(out.final_t)
                + w_depth * jnp.sum(out.depth))
        return loss, (out.color, out.final_t)

    return jax.jit(jax.grad(jloss, argnums=tuple(range(5)), has_aux=True))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_jax(case):
    """``narrowed`` renders 6 channels but backpropagates 4 and no median
    depth (grad_feats=4, carry_depth_grad=False, the SLAM loss's setting):
    the JAX loss then simply has no terms for the dropped rows."""
    means, feats, opac, scales, quats, w, h, k = _scene(
        "saturating" if case == "narrowed" else case
    )
    nf = 6 if case in WIDE else 3
    feats = feats[:, :nf]
    rng = np.random.default_rng(9)
    cot = rng.normal(size=(nf, h, w)).astype(np.float32)
    if case == "narrowed":
        cot[4:] = 0.0
    use_depth = case != "narrowed"

    args = (means, feats, opac, scales, quats)
    jg, (jcolor, jfinal_t) = _jax_grad(w, h)(*args, cot, np.float32(use_depth))

    cam = setup_camera(w, h, k, np.eye(4), device="cpu")
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    res, _, proj = rasterize_tiled_blocks(
        ts[0], ts[1], ts[2], ts[3], normalize(ts[4]), cam, CFG,
        grad_feats=4 if case == "narrowed" else None,
        carry_depth_grad=use_depth,
    )
    color = blocks_to_image(res.color[:, :nf], cam)
    aux = blocks_to_image(res.aux, cam)
    loss = (color * torch.tensor(cot)).sum() + aux[1].sum()
    if use_depth:
        depth = torch.where(aux[0] > 0, aux[0], torch.full_like(aux[0], 15.0))
        loss = loss + depth.sum()
    else:
        assert not res.aux[:, 0].detach().any()
    loss.backward()
    if case in ("saturating", "far_contention"):
        assert bool((res.aux[:, 2, 0] < raster.SAT_INF).any())
    if case == "threshold":  # alpha's floor decides pairs: the forward too
        assert 0.9 < float(aux[1].detach().min()) < 0.999
        np.testing.assert_allclose(aux[1].detach().numpy(),
                                   np.asarray(jfinal_t), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(color.detach().numpy(), np.asarray(jcolor),
                                   atol=1e-5, rtol=1e-4)
    if case == "far_contention":
        k = len(FAR_UV)
        uv = proj.means2d[:k].detach().numpy()
        np.testing.assert_allclose(uv, FAR_UV - 0.5, atol=1e-3)
        # the far gaussians reach into the image, the next covers every tile
        assert bool((proj.tiles_touched[:k] > 0).all())
        assert int(proj.tiles_touched[k]) == res.color.shape[0]
    for t, g, field in zip(ts, jg, ("means", "feats", "opac", "scales", "quats")):
        g = np.asarray(g)
        scale = np.abs(g).max() + 1e-8
        np.testing.assert_allclose(t.grad.numpy() / scale, g / scale,
                                   atol=5e-5, err_msg=field)
        if case == "empty":
            assert not t.grad.abs().any()


def _attrs_and_bins(kind, chunk=128):
    means, feats, opac, scales, quats, w, h, k = _scene(kind)
    cam = setup_camera(w, h, k, np.eye(4), device="cpu")
    proj = preprocess(torch.tensor(means), torch.tensor(scales),
                      normalize(torch.tensor(quats)), cam)
    binned = bin_gaussians_csr(proj, cam,
                               RasterConfig(chunk=chunk, layout="aligned"),
                               opacities=torch.tensor(opac))
    attrs = raster.pack_attrs(proj.means2d, proj.conic, torch.tensor(opac),
                              proj.depths, torch.tensor(feats))
    return attrs, binned, (w + 15) // 16, proj, cam, opac


@pytest.mark.parametrize("carry_depth", [True, False])
def test_plain_backward_matches_autograd(carry_depth):
    """raster_bwd_plain (the analytic backward that kernel B2 computes) is
    the derivative of raster_fwd_plain, on a saturating scene."""
    attrs, binned, gx, *_ = _attrs_and_bins("saturating", chunk=64)
    a = attrs.detach().requires_grad_()
    color, aux, _ = raster.raster_fwd_plain(a, binned.sorted_gid, binned.ranges,
                                            gx, 64, carry_depth)
    rng = np.random.default_rng(1)
    g_color = torch.tensor(rng.normal(size=color.shape).astype(np.float32))
    g_aux = torch.tensor(rng.normal(size=aux.shape).astype(np.float32))
    g_aux[:, 2:] = 0.0
    (color * g_color + aux * g_aux).sum().backward()
    mine = raster.raster_bwd_plain(
        attrs, binned.sorted_gid, binned.ranges, gx, 64, color.detach(),
        aux.detach(), g_color, g_aux, raster.NFEAT_PAD, carry_depth,
    )
    auto = a.grad.clone()
    auto[:, raster.ROW_GID] = 0.0  # the gid row is a label, not a variable
    if not carry_depth:
        auto[:, raster.ROW_DEPTH] = 0.0  # narrowed: the crossing row drops
    scale = auto.abs().max()
    torch.testing.assert_close(mine / scale, auto / scale, atol=5e-5, rtol=0)


def _trim_at(binned, proj, sat):
    """The stream with every instance deeper than its tile's sat dropped."""
    t = binned.counts.shape[0]
    tile = torch.repeat_interleave(torch.arange(t), binned.counts.long())
    keep = proj.depths.detach()[binned.sorted_gid.long()] <= sat[tile]
    counts = torch.bincount(tile[keep], minlength=t)
    ends = torch.cumsum(counts, 0)
    return Binned(binned.sorted_gid[keep],
                  torch.stack([ends - counts, ends], -1).int(), counts.int(),
                  binned.gid_hist, int(keep.sum()))


def test_saturation_depth_properties():
    """The cap is at or past the depth where each saturated tile's last
    pixel died: dropping everything deeper than it leaves the render
    bit for bit unchanged. Re-binning with the cap (binning's depth_cap,
    SAT_MARGIN headroom) drops instances and changes no output."""
    attrs, binned, gx, proj, cam, opac = _attrs_and_bins("saturating")
    color, aux, evaluated = raster.raster_fwd_plain(
        attrs, binned.sorted_gid, binned.ranges, gx, 128
    )
    sat = aux[:, 2, 0]
    assert bool((sat < raster.SAT_INF).any()), "no tile saturated"
    # some tile's pixels all died before the end of its range
    assert bool((evaluated.max(1).values < binned.counts).any())
    trimmed = _trim_at(binned, proj, sat)
    assert trimmed.num_instances < binned.num_instances
    c2, a2, _ = raster.raster_fwd_plain(attrs, trimmed.sorted_gid,
                                        trimmed.ranges, gx, 128)
    assert torch.equal(c2, color) and torch.equal(a2[:, :2], aux[:, :2])

    sat_inf = torch.where(sat < raster.SAT_INF, sat,
                          torch.full_like(sat, float("inf")))
    capped = bin_gaussians_csr(proj, cam, CFG, opacities=torch.tensor(opac),
                               depth_cap=sat_inf)
    assert capped.num_instances < binned.num_instances
    c3, a3, _ = raster.raster_fwd_plain(attrs, capped.sorted_gid,
                                        capped.ranges, gx, 128)
    torch.testing.assert_close(c3, color, atol=1e-6, rtol=0)
    torch.testing.assert_close(a3[:, :2], aux[:, :2], atol=1e-6, rtol=0)
