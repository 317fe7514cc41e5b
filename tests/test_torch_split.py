"""Split stream layout of the port (binning tables, plain kernels B3a-d)
against the JAX package.

The JAX side of the renders is its plain reference, ``backend="jnp"``
with XLA autodiff (which has no layout: the split path must reproduce it).
Tolerances: forward atol 1e-5 / rtol 1e-4 (final T atol 2e-5), gradients
5e-5 of their scale, as tests/test_pallas.py holds its split kernels. The
split binning tables equal JAX's exactly.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatam_torch.core.transforms import normalize
from splatam_torch.render import raster
from splatam_torch.render.binning import (
    BinnedSplit,
    RasterConfig,
    bin_gaussians_csr,
    pair_residues,
)
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.geometry import preprocess
from splatam_torch.render.render_tiled import rasterize_tiled

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def _golden_scenes():
    """tools/make_goldens.py::scenes() as numpy (means, feats, opacities,
    scales, quats, w, h, k)."""
    from make_goldens import scenes

    out = {}
    for name, s in scenes().items():
        w, h = s["cam"].image_width, s["cam"].image_height
        out[name] = tuple(np.asarray(s[k]) for k in
                          ("means", "colors", "opac", "scales", "quats")) + (
            w, h, [[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]])
    return out


def _make_scene(seed, n, opac_boost=0.0, w=96, h=64):
    """tests/test_oracle.py::make_scene with test_pallas.py's opacity boost."""
    from tests.test_oracle import make_scene

    means, colors, opac, scales, quats, _ = make_scene(
        np.random.default_rng(seed), n=n, w=w, h=h)
    if opac_boost:
        opac = np.clip(opac + opac_boost, 0, 0.97).astype(np.float32)
    k = [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]]
    return means, colors, opac, scales, quats, w, h, k


def _interior_only_scene():
    """test_pallas.py::test_split_interior_only_and_empty_scene: one tile
    holds exactly one whole chunk (residue 0)."""
    n, w, h = 128, 64, 48
    rng = np.random.default_rng(3)
    means = np.tile(np.array([[0.02, 0.02, 2.0]], np.float32), (n, 1))
    means[:, 2] += rng.uniform(0, 0.5, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = np.full(n, 0.4, np.float32)
    scales = np.full((n, 3), 0.002, np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    return means, colors, opac, scales, quats, w, h, [
        [80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]]


def _saturating_scene():
    from tests.test_torch_raster import _scene

    return _scene("saturating")


@functools.lru_cache(maxsize=None)
def _scenes():
    """The one scene set the binning, raster and layout tests share."""
    scenes = dict(_golden_scenes())
    scenes["saturating"] = _saturating_scene()
    scenes["split_plain"] = _make_scene(7, 150)
    scenes["split_saturate"] = _make_scene(11, 150, 0.5)
    scenes["dense_saturate"] = _make_scene(9, 400, 0.4)
    scenes["interior_only"] = _interior_only_scene()
    return scenes


def _port_bin(scene, chunk, layout="split"):
    means, feats, opac, scales, quats, w, h, k = scene
    cam = setup_camera(w, h, k, np.eye(4), device="cpu")
    proj = preprocess(torch.tensor(means), torch.tensor(scales),
                      normalize(torch.tensor(quats)), cam)
    binned = bin_gaussians_csr(proj, cam, RasterConfig(chunk=chunk, layout=layout),
                               opacities=torch.tensor(opac))
    attrs = raster.pack_attrs(proj.means2d, proj.conic, torch.tensor(opac),
                              proj.depths, torch.tensor(feats))
    return binned, attrs, (w + 15) // 16


# ---------------------------------------------------------------------------
# Binning tables
# ---------------------------------------------------------------------------

# chunk 32 gives the golden scenes interior chunks too
BIN_CASES = [("sparse_iso", 32), ("dense_aniso", 32), ("overlap_deep", 32),
             ("saturating", 128)]


@pytest.mark.parametrize("name,chunk", BIN_CASES)
def test_split_binning_matches_jax(name, chunk):
    """Every table of bin_gaussians_split, without JAX's pads: counts,
    gid_hist, interior tile/first flags, the tail pairs (tmeta/tsl/tbt),
    the compose masks, tail_cid/tail_role, and the gid stream chunk by
    chunk (the scenes' depths are continuous draws: no ties to reorder)."""
    from splatam_tpu.core.transforms import normalize as jnormalize
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.binning import bin_gaussians_csr as jbin
    from splatam_tpu.render.camera import setup_camera as jsetup
    from splatam_tpu.render.geometry import preprocess as jpreprocess

    scene = _scenes()[name]
    means, _, opac, scales, quats, w, h, k = scene
    jcam = jsetup(w, h, k, np.eye(4))
    cfg = JCfg(max_instances=2**14, max_per_tile=1024, chunk=chunk,
               layout="split")
    jb = jax.jit(lambda m, sc, q, op: jbin(
        jpreprocess(m, sc, jnormalize(q), jcam), jcam, cfg, opacities=op))(
        means, scales, quats, opac)
    assert not bool(jb.overflow)
    tb, _, _ = _port_bin(scene, chunk)
    assert isinstance(tb, BinnedSplit)
    ui, ut = int(jb.used_interior), int(jb.used_tail)
    assert tb.num_instances == int(jb.num_instances)
    assert (tb.chunk_meta.shape[0], tb.tmeta.shape[0]) == (ui, ut)
    np.testing.assert_array_equal(tb.chunk_meta.numpy(),
                                  np.asarray(jb.chunk_meta)[:ui])
    for field in ("tmeta", "tsl", "tbt"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      np.asarray(getattr(jb, field))[:ut],
                                      err_msg=field)
    for field in ("counts", "gid_hist", "mask_int", "mask_a", "mask_b",
                  "tail_cid", "tail_role"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      np.asarray(getattr(jb, field)),
                                      err_msg=field)
    jgid = np.asarray(jb.sorted_gid)
    gid = tb.sorted_gid.numpy()
    np.testing.assert_array_equal(gid[: ui * chunk], jgid[: ui * chunk])
    nci = jb.chunk_meta.shape[0]  # JAX's padded interior capacity
    lim = tb.tsl.numpy() & 0xFFFF
    for c in range(ut):
        got = gid[(ui + c) * chunk:(ui + c) * chunk + lim[c]]
        ref = jgid[(nci + c) * chunk:(nci + c) * chunk + lim[c]]
        np.testing.assert_array_equal(got, ref, err_msg=f"tail chunk {c}")
    # the interior ranges tile the interior region in tile order
    q = tb.counts.numpy() // chunk
    ranges = tb.int_ranges.numpy()
    np.testing.assert_array_equal(ranges[:, 1] - ranges[:, 0], q * chunk)


def test_residue_pairing_is_optimal():
    """The binary-searched pair count equals the greedy two-pointer
    matching's (the optimum) on random residues, and every pair fits."""
    rng = np.random.default_rng(5)
    for chunk in (16, 128):
        for _ in range(20):
            r = rng.integers(0, chunk, rng.integers(1, 60))
            order, cid, role_b, big_r, used_t = pair_residues(r, chunk)
            rs = sorted(r[r > 0], reverse=True)
            i, j, pairs = 0, len(rs) - 1, 0
            while i < j:
                if rs[i] + rs[j] <= chunk:
                    pairs, j = pairs + 1, j - 1
                i += 1
            assert used_t == big_r - pairs
            load = np.zeros(used_t, np.int64)
            np.add.at(load, cid[:big_r], r[order[:big_r]])
            assert (load <= chunk).all() and role_b.sum() == pairs


# ---------------------------------------------------------------------------
# Plain split kernels against the JAX oracle and the port's aligned path
# ---------------------------------------------------------------------------


N_PAD = 400  # the 96x64 scenes share one JAX compile at this size


def _padded(scene):
    """(scene padded to N_PAD gaussians with copies of the first, active
    mask); the padding is inactive in both packages."""
    means, colors, opac, scales, quats, w, h, k = scene
    n = len(means)
    slot = np.arange(max(n, N_PAD))
    idx = np.where(slot < n, slot, 0)
    arrays = [x[idx] for x in (means, colors, opac, scales, quats)]
    return (*arrays, w, h, k), slot < n


@functools.lru_cache(maxsize=None)
def _jax_grad(n, w, h, kscale):
    """jax.grad of sum(color^2) + sum(depth) through the jnp path, and the
    render, wrt means, colors, opacities and a screen-space offset on the
    means (``means2d_dummy``, passed as zeros); one compile per scene
    shape."""
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.camera import setup_camera as jsetup
    from splatam_tpu.render.render_tiled import rasterize_tiled as jrt

    jcam = jsetup(w, h, [[kscale, 0, w / 2], [0, kscale, h / 2], [0, 0, 1]],
                  np.eye(4))
    # capacities above every scene's counts (the overflow flag says so)
    cfg = JCfg(max_instances=2**13, max_per_tile=256, chunk=128,
               backend="jnp")

    def loss(means, colors, opac, dummy, scales, quats, active):
        out, aux = jrt(means, colors, opac, scales, quats, jcam, cfg=cfg,
                       active=active, means2d_dummy=dummy)
        return jnp.sum(out.color**2) + jnp.sum(out.depth), (out, aux.overflow)

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                      has_aux=True))

    def run(means, colors, opac, scales, quats, active):
        (_, (out, overflow)), g = grad(means, colors, opac, jnp.zeros((n, 2)),
                                       scales, quats, active)
        assert not bool(overflow)
        return out, [np.asarray(x) for x in g]

    return run


def _jax_reference(scene):
    padded, active = _padded(scene)
    means, colors, opac, scales, quats, w, h, k = padded
    out, grads = _jax_grad(len(means), w, h, k[0][0])(
        means, colors, opac, scales, quats, active)
    return out, [g[active] for g in grads]


def _port_render(scene, chunk, layout="split", active=None):
    """The port's render and the gradients of the same loss wrt means,
    colors, opacities and the screen-space offset."""
    means, colors, opac, scales, quats, w, h, k = scene
    cam = setup_camera(w, h, k, np.eye(4), device="cpu")
    ts = [torch.tensor(x, requires_grad=True) for x in (means, colors, opac)]
    dummy = torch.zeros((len(means), 2), requires_grad=True)
    out, aux = rasterize_tiled(ts[0], ts[1], ts[2], torch.tensor(scales),
                               torch.tensor(quats), cam,
                               cfg=RasterConfig(chunk=chunk, layout=layout),
                               active=active, means2d_dummy=dummy,
                               device="cpu")
    ((out.color**2).sum() + out.depth.sum()).backward()
    return out, aux, [t.grad for t in ts] + [dummy.grad]


def _check_grads(grads, ref):
    for g, r in zip(grads, ref):
        scale = np.abs(r).max() + 1e-20
        np.testing.assert_allclose(g.numpy() / scale, r / scale, atol=5e-5)


RASTER_CASES = [("split_plain", 128), ("split_saturate", 128),
                ("dense_saturate", 256), ("dense_saturate", 512),
                ("interior_only", 128)]


@pytest.mark.parametrize("name,chunk", RASTER_CASES)
def test_split_render_and_grads_match_jnp(name, chunk):
    """The plain split forward (B3a + B3b + compose) and backward
    (B3c + B3d) against the JAX oracle: the scenes of test_pallas.py's
    split tests, saturating ones included, and chunk sizes 256/512."""
    scene = _scenes()[name]
    ref, jg = _jax_reference(scene)
    out, _, grads = _port_render(scene, chunk)
    for field in ("color", "depth"):
        np.testing.assert_allclose(getattr(out, field).detach().numpy(),
                                   np.asarray(getattr(ref, field)),
                                   atol=1e-5, rtol=1e-4, err_msg=field)
    np.testing.assert_allclose(out.final_t.detach().numpy(),
                               np.asarray(ref.final_t), atol=2e-5, rtol=1e-4)
    _check_grads(grads, jg)  # means, colors, opacities, means2d_dummy
    binned, _, _ = _port_bin(scene, chunk)
    if name == "interior_only":  # no residue anywhere
        assert binned.mask_int.any() and binned.tmeta.shape[0] == 0
    else:
        assert binned.tmeta.shape[0] > 0


def test_split_empty_scene():
    """No instance at all: every tile takes the empty aux (T 1), color 0,
    no launch of a tail kernel's plain version has anything to do, and the
    gradients are zero."""
    scene = _scenes()["interior_only"]
    out, aux, grads = _port_render(scene, 128,
                                   active=np.zeros(len(scene[0]), bool))
    assert aux.num_instances == 0
    np.testing.assert_allclose(out.final_t.detach().numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out.color[:3].detach().numpy(), 0.0, atol=1e-6)
    assert torch.isinf(aux.sat_depth).all()
    for g in grads:
        assert not g.abs().any()


@pytest.mark.parametrize("name,chunk", [("saturating", 64), ("dense_aniso", 32),
                                        ("split_saturate", 128)])
@pytest.mark.parametrize("carry_depth", [True, False])
def test_split_matches_aligned_plain(name, chunk, carry_depth):
    """The split kernels' plain versions against the aligned ones (B1/B2)
    on the same scene: the split layout cuts each tile's range at the same
    batch boundaries, so the render is equal bit for bit (saturation depth
    included) and the gradients agree to summation order; each carry
    holds the tile's state at the interior's end."""
    scene = _scenes()[name]
    sb, attrs, gx = _port_bin(scene, chunk, "split")
    ab, _, _ = _port_bin(scene, chunk, "aligned")
    color_a, aux_a, _ = raster.raster_fwd_plain(attrs, ab.sorted_gid,
                                                ab.ranges, gx, chunk,
                                                carry_depth)
    c_i, a_i, carry, _ = raster.raster_split_int_fwd_plain(
        attrs, sb, gx, chunk, carry_depth)
    cp, ap, _ = raster.raster_split_tail_fwd_plain(attrs, sb, carry, gx,
                                                   chunk, carry_depth)
    color, aux = raster.compose_split(sb, c_i, a_i, cp, ap)
    assert torch.equal(color, color_a) and torch.equal(aux, aux_a)
    # a tile whose interior saturated carries its death in the sign
    dead_int = (carry[:, 0] < 0).all(1) & sb.mask_int
    assert torch.equal(a_i[dead_int, 2], aux_a[dead_int, 2])

    rng = np.random.default_rng(4)
    g_color = torch.tensor(rng.normal(size=color.shape).astype(np.float32))
    g_aux = torch.tensor(rng.normal(size=aux.shape).astype(np.float32))
    g_aux[:, 2:] = 0.0
    if not carry_depth:
        g_aux[:, 0] = 0.0
    args = (gx, chunk, color, aux, g_color, g_aux, raster.NFEAT_PAD,
            carry_depth)
    grad_a = raster.raster_bwd_plain(attrs, ab.sorted_gid, ab.ranges, *args)
    grad, bcarry = raster.raster_split_int_bwd_plain(attrs, sb, *args)
    grad = raster.raster_split_tail_bwd_plain(attrs, sb, bcarry, *args,
                                              grad=grad)
    scale = grad_a.abs().max().item()
    np.testing.assert_allclose(grad.numpy() / scale, grad_a.numpy() / scale,
                               atol=5e-5)
    # the backward replays the forward's deaths: same signs in both carries
    assert torch.equal(bcarry[:, 0] < 0, carry[:, 0] < 0)


@pytest.mark.parametrize("name,chunk", [("dense_saturate", 64),
                                        ("saturating", 64),
                                        ("interior_only", 128),
                                        ("dense_aniso", 32)])
def test_split_tail_finishes_its_tiles_in_place(name, chunk):
    """What B3b's in-place write on the card relies on, on the plain
    versions: every tile has at most one tail segment; B3a's outputs for a
    tile with no interior are compose_split's empty block bit for bit; and
    each tail segment's color added into its tile's B3a color, with aux
    rows 0-2 overwritten by the segment's, is compose_split's output bit for
    bit. The scenes: tails after an interior and alone; tails whose tile
    died in its interior; interiors and empty tiles with no tail."""
    sb, attrs, gx = _port_bin(_scenes()[name], chunk)
    tail = sb.mask_a | sb.mask_b
    assert not (sb.mask_a & sb.mask_b).any()
    blk = (sb.tail_cid * 2 + sb.tail_role).long()[tail]
    assert blk.unique().numel() == blk.numel()
    c_i, a_i, carry, _ = raster.raster_split_int_fwd_plain(attrs, sb, gx, chunk)
    cp, ap, _ = raster.raster_split_tail_fwd_plain(attrs, sb, carry, gx, chunk)
    color, aux = raster.compose_split(sb, c_i, a_i, cp, ap)

    no_int = ~sb.mask_int
    e_color, e_aux = raster.compose_split(
        sb._replace(mask_int=torch.zeros_like(sb.mask_int)), c_i, a_i,
        cp[:0], ap[:0])
    assert torch.equal(c_i[no_int], e_color[no_int])
    assert torch.equal(a_i[no_int], e_aux[no_int])

    c_t, a_t = c_i.clone(), a_i.clone()
    c_t[tail] = c_t[tail] + cp.reshape(-1, raster.NFEAT_PAD, raster.NPIX)[blk]
    a_t[tail, :3] = ap.reshape(-1, raster.NFEAT_PAD, raster.NPIX)[blk, :3]
    assert torch.equal(c_t, color) and torch.equal(a_t, aux)
    assert not a_i[:, 3:].any()


def test_means2d_dummy_gradient_matches_jax():
    """The gradient of a screen-space offset on the means (what Inria
    densification accumulates) against the JAX oracle's, in the aligned
    layout; test_split_render_and_grads_match_jnp checks it in the split
    layout on every scene."""
    scene = _scenes()["split_saturate"]
    _, jg = _jax_reference(scene)
    _, _, grads = _port_render(scene, 128, "aligned")
    assert np.abs(jg[3]).max() > 0
    _check_grads(grads[3:], jg[3:])
