"""Port Fisher path (plain version of kernel B4, fisher/, the gains handler)
against the JAX package.

The JAX side runs as tests/test_fisher.py runs it: ``backend="pallas"``,
chunk 128, the Pallas kernels in interpret mode on the CPU. Each JAX
reference is computed once, in module fixtures, under ``jax.jit`` (eager
interpret mode costs seconds per call). Tolerances: moments per column to
1e-5 of that column's largest magnitude (the seed makes them products of
~1e-3 gradients, so no absolute bound fits), against their float64
evaluation and JAX's (5e-5 on the saturating scene, where JAX's own error
is 2.5e-5); the Fisher to 1e-4 of scale
against JAX and 5e-5 against the port's own per-pixel autodiff oracle (the
bound of test_fisher.py); silhouette gains to one pixel of W*H; EIG to a
relative 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from splatam_torch.core.params import append_gaussians, params_from_numpy
from splatam_torch.fisher import (
    eig_score,
    fisher_h_train,
    h_train_inverse,
    nonlinear_gain,
    render_fisher,
    render_gains,
    silhouette_gain,
    sized_fisher_config,
)
from splatam_torch.fisher.fisher import fisher_config
from splatam_torch.realtime.handler import (
    ActiveViewHandler,
    GainConfig,
    _w2c_rt,
    pose_matrix_from_quaternion,
)
from splatam_torch.render import raster
from splatam_torch.render.binning import Binned, RasterConfig, bin_gaussians_csr
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.geometry import grid_dims, preprocess
from splatam_torch.core.transforms import normalize

from tests.test_oracle import make_scene

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

SEED = 1e-3
W, H = 48, 32
CFG = RasterConfig(chunk=128)  # split, as configs default: Fisher bins aligned
MOM_TOL = 1e-5  # per column, of the column's largest magnitude
FISHER_TOL = 1e-4  # of the largest magnitude, against JAX
EIG_RTOL = 1e-4


def _jcfg():
    from splatam_tpu.render.binning import RasterConfig as JCfg

    return JCfg(max_instances=4096, max_per_tile=256, chunk=128,
                backend="pallas")


def _k(w, h):
    return np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]])


def _saturating(n=24):
    """Opaque, wide gaussians in front of the camera: every pixel of most
    tiles dies."""
    rng = np.random.default_rng(9)
    means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(0.8, 3.0, n)], -1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = np.full(n, 0.95, np.float32)
    scales = np.full((n, 3), 0.5, np.float32)
    quats = np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32)
    return means, colors, opac, scales, quats


def _scene_a():
    """test_fisher.py's autodiff scene: 24 gaussians at 48x32."""
    return make_scene(np.random.default_rng(0), n=24, w=W, h=H)[:5]


def _port_setup(scene):
    means, colors, opac, scales, quats = (torch.as_tensor(x) for x in scene)
    cam = setup_camera(W, H, _k(W, H), np.eye(4), device="cpu")
    proj = preprocess(means, scales, normalize(quats), cam)
    binned = bin_gaussians_csr(proj, cam, fisher_config(CFG), opacities=opac)
    attrs = raster.pack_attrs(proj.means2d, proj.conic, opac, proj.depths,
                              colors)
    return attrs, binned, cam


def _seed():
    s = torch.zeros(raster.NFEAT_PAD)
    s[:3] = SEED
    return s


def _port_params(scene):
    """Raw parameters (the SLAM schema) of a numpy scene."""
    means, colors, opac, scales, quats = scene
    return {
        "means3D": torch.as_tensor(means),
        "rgb_colors": torch.as_tensor(colors),
        "unnorm_rotations": torch.as_tensor(quats),
        "logit_opacities": torch.as_tensor(
            np.log(opac / (1 - opac)).reshape(-1, 1).astype(np.float32)),
        "log_scales": torch.as_tensor(np.log(scales).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def jax_moments():
    """JAX fisher_moments (Pallas, interpret mode) on scene A and the
    saturating scene: one compiled program, same shapes."""
    import jax
    import jax.numpy as jnp

    from splatam_tpu.core.transforms import normalize as jnormalize
    from splatam_tpu.render.binning import bin_gaussians_csr as jbin
    from splatam_tpu.render.camera import setup_camera as jsetup
    from splatam_tpu.render.geometry import preprocess as jpreprocess
    from splatam_tpu.render.pallas_raster import fisher_moments, pack_attrs

    jcam = jsetup(W, H, _k(W, H), np.eye(4))
    gx, gy = (W + 15) // 16, (H + 15) // 16
    cfg = dataclasses.replace(_jcfg(), layout="aligned")  # fisher_config

    @jax.jit
    def moments(means, colors, opac, scales, quats):
        proj = jpreprocess(means, scales, jnormalize(quats), jcam)
        binned = jbin(proj, jcam, cfg, opacities=opac)
        attrs = pack_attrs(proj.means2d, proj.conic, opac, proj.depths,
                           colors)
        seed = jnp.zeros(8, jnp.float32).at[:3].set(SEED)
        return fisher_moments(attrs, binned, gx * gy, gx, cfg.chunk, seed)

    return {name: np.asarray(moments(*scene)) for name, scene in
            (("scene_a", _scene_a()), ("saturating", _saturating()))}


@pytest.mark.parametrize("name", ["scene_a", "saturating"])
def test_fisher_moments_plain_matches_jax(jax_moments, name):
    scene = _scene_a() if name == "scene_a" else _saturating()
    attrs, binned, cam = _port_setup(scene)
    assert isinstance(binned, Binned)
    gx, _ = grid_dims(cam)
    color, aux, _ = raster.raster_fwd_plain(
        attrs, binned.sorted_gid, binned.ranges, gx, 128)
    if name == "saturating":  # the replay's pixel deaths are exercised
        assert int((aux[:, 2, 0] < raster.SAT_INF).sum()) >= 4
    mom = raster.fisher_moments(attrs, binned, gx, 128, _seed())
    assert mom.shape == (scene[0].shape[0], raster.FISHER_ROWS)
    # the same arithmetic in float64: f32 rounding only
    exact = raster.fisher_moments(attrs.double(), binned, gx, 128,
                                  _seed().double()).numpy()
    scale = np.abs(exact).max(axis=0)
    assert np.all(scale > 0)
    assert np.all(np.abs(mom.numpy() - exact).max(axis=0) <= MOM_TOL * scale)
    # JAX's kernel composites in log space on the MXU (bf16-split cumsums):
    # on the saturating scene it is itself 2.5e-5 of scale off the float64
    # evaluation, where the port's f32 is 1.5e-6 off
    err = np.abs(mom.numpy() - jax_moments[name]).max(axis=0)
    jax_tol = MOM_TOL if name == "scene_a" else 5 * MOM_TOL
    assert np.all(err <= jax_tol * scale), err / scale
    # the diagonal moments are sums of squares
    diag = [r for r, (a, b) in enumerate(raster.TRI_PAIRS) if a == b] + [15]
    assert torch.all(mom[:, diag] >= 0)
    # a shared forward (tile_color) gives the same moments
    shared = raster.fisher_moments(attrs, binned, gx, 128, _seed(),
                                   tile_color=color)
    torch.testing.assert_close(shared, mom, rtol=0, atol=0)


def _moment_cases(rng):
    """B4's per-(tile, instance) inputs, made in numpy: a gated dop^2 per
    pixel of a 16x16 tile (pixel coordinates offset from the tile centre),
    the sum kept apart, and per instance the mean's offset from the tile
    centre, a positive-definite conic and an opacity. Three groups of 40:
    means inside the tile with footprints over it, means 100-600 px off it,
    and narrow footprints (sigma 0.4-1.5 px) inside it."""
    p = np.arange(raster.NPIX)
    x, y = p % 16 - 7.5, p // 16 - 7.5
    k = 40
    inside = rng.uniform(-8, 8, (k, 2))
    ang, dist = rng.uniform(0, 2 * np.pi, k), rng.uniform(100, 600, k)
    far = np.stack([dist * np.cos(ang), dist * np.sin(ang)], -1)
    narrow = rng.uniform(-7, 7, (k, 2))
    mean = np.concatenate([inside, far, narrow])
    dop = rng.normal(0, 1e-3, (3 * k, raster.NPIX))
    dop *= rng.uniform(size=dop.shape) < 0.8  # pairs that add nothing
    sigma = rng.uniform(0.4, 1.5, k)
    r2 = ((x - narrow[:, :1]) ** 2 + (y - narrow[:, 1:]) ** 2)
    foot = np.exp(-r2 / (2 * sigma[:, None] ** 2))
    dop[2 * k:] *= foot * (foot > 1 / 255)
    a = rng.uniform(0.01, 1.0, 3 * k)
    c = rng.uniform(0.01, 1.0, 3 * k)
    b = rng.uniform(-0.9, 0.9, 3 * k) * np.sqrt(a * c)
    op = rng.uniform(0.1, 1.0, 3 * k)
    apart = rng.uniform(0, 1e-6, 3 * k) * (rng.uniform(size=3 * k) < 0.2)
    return x, y, dop, apart, mean, (a, b, c), op


def test_fisher_rows_from_moments_match_the_direct_sums():
    """B4's flush algebra: its 16 rows from the pixel moments equal the
    direct sums of v_a v_b (a <= b) and of dop^2 to 1e-9 of each column's
    largest value in float64; in float32, with every moment off by 2^-20 of
    its own size (3xTF32's precision), within FISHER_TOL = 1e-4 of it."""
    rng = np.random.default_rng(5)
    x, y, dop, apart, mean, (a, b, c), op = _moment_cases(rng)
    xl, yl = mean[:, :1], mean[:, 1:]
    dx, dy = xl - x, yl - y
    dpower = op[:, None] * dop
    v = (dpower * -(a[:, None] * dx + b[:, None] * dy),
         dpower * -(c[:, None] * dy + b[:, None] * dx),
         dpower * (-0.5 * dx * dx), dpower * -(dx * dy),
         dpower * (-0.5 * dy * dy))
    direct = np.stack([(v[i] * v[j]).sum(-1) for i, j in raster.TRI_PAIRS]
                      + [(dop * dop).sum(-1) + apart], -1)
    basis = [x ** (d - e) * y ** e for d in range(5) for e in range(d + 1)]
    s = np.stack([((dop * dop) * m).sum(-1) for m in basis] + [apart], -1)
    scale = np.abs(direct).max(axis=0)
    assert np.all(scale > 0)

    def rows(s, dtype):
        t = lambda z: torch.as_tensor(np.asarray(z, dtype))  # noqa: E731
        return raster.fisher_rows_from_moments(
            t(s), t(mean[:, 0]), t(mean[:, 1]), t(a), t(b), t(c),
            t(op)).double().numpy()

    err64 = np.abs(rows(s, np.float64) - direct).max(axis=0)
    assert np.all(err64 <= 1e-9 * scale), err64 / scale
    off = s * (1 + 2.0 ** -20 * rng.choice([-1.0, 1.0], s.shape))
    err32 = np.abs(rows(off, np.float32) - direct).max(axis=0)
    assert np.all(err32 <= FISHER_TOL * scale), err32 / scale


def _skip_margin():
    """raster_fisher.cu's SKIP_MARGIN, read from the kernel's source."""
    import re
    from pathlib import Path

    src = (Path(raster.__file__).parent / "csrc" / "raster_fisher.cu").read_text()
    m = re.search(r"constexpr float SKIP_MARGIN = ([0-9.eE+-]+)f;", src)
    assert m, "raster_fisher.cu no longer defines SKIP_MARGIN"
    return float(m.group(1))


def _skip_counts(kind):
    """On chip_smoke's scene ``kind`` at chunk 128: the valid (pixel,
    instance) pairs, those B4's alpha skip drops (power below log(1/255 /
    op) - SKIP_MARGIN), those of them whose alpha is not 0 as the plain
    version computes it, and those within twice the margin above the
    bound."""
    from chip_smoke import scene_setup, small_scene

    margin = _skip_margin()
    s = scene_setup(small_scene(kind), torch.device("cpu"))
    px, py = raster._pixel_centers(torch.arange(s.binned.ranges.shape[0]),
                                   s.grid_x)
    pairs = dropped = wrong = near = 0
    for rows, _, valid in raster._blocks(s.attrs, s.binned.sorted_gid,
                                         s.binned.ranges, s.chunk):
        praw, alpha = (raster._pairs(rows, px, py)[i] for i in (2, 5))
        pmin = (torch.log(raster.ALPHA_MIN / rows[..., raster.ROW_OP])
                - margin)[..., None]
        v = valid[..., None].expand_as(praw)
        drop = v & (praw < pmin)
        pairs += int(v.sum())
        dropped += int(drop.sum())
        wrong += int((drop & (alpha > 0)).sum())
        near += int((v & (praw >= pmin) & (praw < pmin + 2 * margin)).sum())
    return pairs, dropped, wrong, near


def test_fisher_alpha_skip_drops_only_pairs_with_alpha_zero():
    """B4 drops a pair before its exp where its power lies below
    log(1/255 / op) - SKIP_MARGIN (raster_fisher.cu). On chip_smoke's
    threshold scene (op exp(power) within 2% of 1/255 at ~12,000 pairs)
    every pair that bound drops has alpha 0 as the plain version computes
    it, some pairs lie within the margin above the bound, and most pairs
    are dropped."""
    pairs, dropped, wrong, near = _skip_counts("threshold")
    assert wrong == 0
    assert near > 0 and dropped > pairs // 2


@pytest.mark.parametrize("kind", ["far_contention", "saturating"])
def test_fisher_alpha_skip_keeps_every_pair_with_alpha(kind):
    """The same rule on chip_smoke's opaque scenes (op 0.3-0.95, means far
    off their tiles, saturated tiles): every pair the skip drops has alpha
    0, and it drops some."""
    pairs, dropped, wrong, _ = _skip_counts(kind)
    assert wrong == 0
    assert 0 < dropped < pairs


def test_fisher_moments_needs_aligned_binning():
    means, _, opac, scales, quats = (torch.as_tensor(x) for x in _scene_a())
    attrs, _, cam = _port_setup(_scene_a())
    proj = preprocess(means, scales, normalize(quats), cam)
    split = bin_gaussians_csr(proj, cam, CFG, opacities=opac)
    with pytest.raises(ValueError, match="aligned"):
        raster.fisher_moments(attrs, split, grid_dims(cam)[0], 128, _seed())


def _identity_pose():
    return torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)


def _dense_rgb_sum(params, cam):
    """Seeded per-pixel RGB sum of a dense, differentiable composite of
    every gaussian, in depth order, with the kernels' alpha and death rules
    and their tile rects (a gaussian only reaches the tiles its rect
    covers)."""
    from splatam_torch.render.geometry import ALPHA_CAP, ALPHA_MIN, T_STOP, TILE

    means = params["means3D"]
    opac = torch.sigmoid(params["logit_opacities"]).reshape(-1)
    proj = preprocess(means, torch.exp(params["log_scales"]),
                      normalize(params["unnorm_rotations"]), cam)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    tx, ty = (px // TILE).long(), (py // TILE).long()
    trans = torch.ones_like(px)
    dead = torch.zeros(px.shape, dtype=torch.bool)
    rgb = torch.zeros_like(px)
    colsum = params["rgb_colors"].sum(-1)
    for g in torch.argsort(proj.depths.detach(), stable=True).tolist():
        if int(proj.radius[g]) <= 0:
            continue
        rmin, rmax = proj.rect_min[g], proj.rect_max[g]
        inside = ((tx >= rmin[0]) & (tx < rmax[0]) & (ty >= rmin[1])
                  & (ty < rmax[1]))
        dx = proj.means2d[g, 0] - px
        dy = proj.means2d[g, 1] - py
        a, b, c = proj.conic[g, 0], proj.conic[g, 1], proj.conic[g, 2]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(opac[g] * torch.exp(torch.clamp(power, max=0.0)),
                            max=ALPHA_CAP)
        use = inside & ~dead & (alpha >= ALPHA_MIN)
        test = trans * (1 - alpha)
        dies = use & (test < T_STOP)
        take = use & ~dies
        rgb = rgb + torch.where(take, alpha * trans, torch.zeros_like(px)) * colsum[g]
        trans = torch.where(take, test, trans)
        dead = dead | dies
    return SEED * rgb


def test_render_fisher_matches_pixelwise_autodiff():
    """The port's Fisher against its own oracle: the per-pixel Jacobian of
    the seeded RGB render, squared and summed over pixels (tests/test_fisher.py
    ``_oracle_fisher``). Forward mode (jacfwd) builds the same Jacobian as
    jacrev from 96 input columns instead of 1536 pixel rows, 10x faster."""
    params = _port_params(_scene_a())
    cam = setup_camera(W, H, _k(W, H), np.eye(4), device="cpu")
    h = render_fisher(params, None, *_identity_pose(), cam, CFG,
                      seed_value=SEED)

    def pixels(means3d, logit_op):
        p = dict(params, means3D=means3d, logit_opacities=logit_op)
        return _dense_rgb_sum(p, cam)

    jm, jo = torch.func.jacfwd(pixels, argnums=(0, 1))(
        params["means3D"], params["logit_opacities"])
    op = torch.sigmoid(params["logit_opacities"]).reshape(-1)
    jo = jo.reshape(jo.shape[0], -1) / (op * (1 - op))[None, :]
    ref = torch.cat([(jm ** 2).sum(0), (jo ** 2).sum(0)[:, None]], dim=-1)
    scale = ref.abs().max()
    assert h.shape == ref.shape and torch.all(h >= 0)
    assert float((h - ref).abs().max()) <= 5e-5 * float(scale)
    # the Fisher path bins aligned whatever the config's layout
    h_al = render_fisher(params, None, *_identity_pose(), cam,
                         RasterConfig(chunk=128, layout="aligned"),
                         seed_value=SEED)
    torch.testing.assert_close(h_al, h, rtol=0, atol=0)
    assert sized_fisher_config(params, None, *_identity_pose(), cam,
                               CFG).layout == "aligned"


def test_fisher_h_train_matches_per_pose_sum():
    """Weighted poses sum; a pose of weight 0 adds nothing."""
    params = _port_params(_scene_a())
    cam = setup_camera(W, H, _k(W, H), np.eye(4), device="cpu")
    rots = torch.tensor([[1.0, 0, 0, 0]] * 4)
    trans = torch.tensor([[0, 0, 0], [0.01, 0, 0], [0, 0.01, 0],
                          [9.9, 9.9, 9.9]])
    wgt = torch.tensor([1.0, 1.0, 1.0, 0.0])
    h_sum = sum(render_fisher(params, None, rots[i], trans[i], cam, CFG,
                              seed_value=SEED) for i in range(3))
    h_train, over = fisher_h_train(params, None, rots, trans, wgt, cam, CFG,
                                   seed_value=SEED)
    assert over is False
    scale = float(h_sum.abs().max())
    assert float((h_train - h_sum).abs().max()) <= 1e-6 * scale


# ---------------------------------------------------------------------------
# The handler against JAX's, on one map carried across
# ---------------------------------------------------------------------------

N_MAP, N_LATE = 40, 8  # map rows, then rows appended after the recompute
HOLES = (5, 17)  # inactive rows of the JAX map
VISITED = [(0.0, 0.0, 0.0), (0.02, 0.0, 0.0), (0.0, 0.015, -0.02)]
CANDIDATES = [
    np.array([0.0, 0.0, 0.0, 0, 0, 0, 1.0]),
    np.array([0.03, -0.02, 0.0, 0, 0, 0, 1.0]),
    np.array([0.0, 0.0, -2.5, 0, 0, 0, 1.0]),
]
GAINS = dict(k_sil=1000.0, k_eig=0.1, k_sum=1.0, monte_carlo=2)


def _c2w(t):
    c2w = np.eye(4)
    c2w[:3, 3] = t
    return c2w


def _map_scene():
    return make_scene(np.random.default_rng(3), n=N_MAP + N_LATE, w=W, h=H)[:5]


def _map_active(late=False):
    active = np.ones(N_MAP + N_LATE, bool)
    active[list(HOLES)] = False
    if not late:
        active[N_MAP:] = False
    return active


@pytest.fixture(scope="module")
def handlers():
    """JAX's ActiveViewHandler and the port's, on the same map (the port's
    holds the JAX map's active rows), generator seed, visited poses and
    candidates: H_train_inv, gains, and gains again after rows join the
    map without a recompute."""
    import jax.numpy as jnp

    import splatam_tpu.realtime.handler as jhandler
    from splatam_tpu.fisher.fisher import fisher_config as jfisher_config
    from tests.test_fisher import _params_from_scene

    scene = _map_scene()
    means, colors, opac, scales, quats = scene
    n = means.shape[0]
    jp, _ = _params_from_scene(means, colors, opac, scales, quats, n)
    jp = {k: v for k, v in jp.items() if not k.startswith("cam_")}
    from splatam_tpu.render.camera import setup_camera as jsetup

    jcam = jsetup(W, H, _k(W, H), np.eye(4))
    jh = jhandler.ActiveViewHandler(jcam, _jcfg(), jhandler.GainConfig(**GAINS),
                                    rng=np.random.default_rng(5))
    cam = setup_camera(W, H, _k(W, H), np.eye(4), device="cpu")
    ph = ActiveViewHandler(cam, CFG, GainConfig(**GAINS),
                           rng=np.random.default_rng(5))
    for t in VISITED:
        jh.add_visited_pose(_c2w(t))
        ph.add_visited_pose(_c2w(t))

    np_params = {k: np.asarray(v) for k, v in jp.items()}
    params, variables = params_from_numpy(np_params,
                                          {"active": _map_active()},
                                          device="cpu")
    active = jnp.asarray(_map_active())
    # JAX's handler at its unsized capacities: its sized_fisher_config probe
    # (~9 s of eager dispatch here) only shrinks the capacities, which
    # changes no result (tests/test_fisher.py holds sized to unsized)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhandler, "sized_fisher_config",
                   lambda *a, margin: jfisher_config(a[5]))
        jh.recompute_h_train_inv(jp, active)
        j_gains = jh.compute_gains(jp, active, CANDIDATES)
        # rows N_MAP.. join both maps after the recompute: the JAX map
        # activates its slots, the port's appends them at the end
        j_gains_late = jh.compute_gains(
            jp, jnp.asarray(_map_active(True)), CANDIDATES)
    ph.recompute_h_train_inv(params, None)
    out = dict(
        jh=jh, ph=ph, params=params, jp=jp, cam=cam,
        j_hinv=np.asarray(jh.h_train_inv), p_hinv=ph.h_train_inv.copy(),
        j_gains=j_gains, p_gains=ph.compute_gains(params, None, CANDIDATES),
        next_draws=(jh.rng.integers(1 << 30), ph.rng.integers(1 << 30)),
    )
    late = {k: np_params[k][N_MAP:] for k in np_params}
    params2, _ = append_gaussians(params, variables, late, time_idx=1)
    out["j_gains_late"] = j_gains_late
    out["p_gains_late"] = ph.compute_gains(params2, None, CANDIDATES)
    out["params_late"] = params2
    return out


def test_handler_h_train_inv_matches_jax(handlers):
    """Same Monte-Carlo draw (2 of 3 visited poses from the shared
    generator), same H_train over the active rows."""
    j = handlers["j_hinv"][_map_active()]
    p = handlers["p_hinv"]
    assert p.shape == j.shape == (N_MAP - len(HOLES), 4)
    h_j, h_p = 1.0 / j - 0.1, 1.0 / p - 0.1  # H_train, eps 0.1
    assert np.abs(h_p - h_j).max() <= FISHER_TOL * np.abs(h_j).max()
    assert handlers["next_draws"][0] == handlers["next_draws"][1]


def _check_gains(got, ref):
    assert len(got) == len(ref) == len(CANDIDATES)
    pixel = GAINS["k_sil"] / (W * H)
    for g, r in zip(got, ref):
        assert abs(g["sil"] - r["sil"]) <= pixel + 1e-6 * GAINS["k_sil"]
        assert g["eig"] > 0
        assert abs(g["eig"] - r["eig"]) <= EIG_RTOL * abs(r["eig"])
        assert abs(g["gain"] - r["gain"]) <= pixel + EIG_RTOL * abs(r["eig"]) + 1e-6


def test_handler_gains_match_jax(handlers):
    _check_gains(handlers["p_gains"], handlers["j_gains"])
    # the far pose sees mostly unmapped space
    assert handlers["p_gains"][2]["sil"] > handlers["p_gains"][0]["sil"]


def test_h_train_inv_rows_follow_appends(handlers):
    """Rows appended since the recompute count with 1 / eps, as the JAX
    map's zero-Fisher slots do, and the EIG equals JAX's over the active
    gaussians."""
    ph, params2 = handlers["ph"], handlers["params_late"]
    n0 = handlers["p_hinv"].shape[0]
    n = params2["means3D"].shape[0]
    assert n == n0 + N_LATE
    hinv = ph.aligned_h_train_inv(n)
    torch.testing.assert_close(hinv[:n0], torch.as_tensor(handlers["p_hinv"]))
    assert torch.all(hinv[n0:] == 1.0 / 0.1)
    _check_gains(handlers["p_gains_late"], handlers["j_gains_late"])
    assert (handlers["p_gains_late"][0]["eig"]
            != handlers["p_gains"][0]["eig"])
    # the EIG of one pose by the handler's own path
    w2c = np.linalg.inv(_c2w(VISITED[1]))
    h = ph.compute_hessian(params2, None, w2c)
    assert ph.compute_eig_score(params2, None, w2c) == pytest.approx(
        float(np.sum(h * hinv.numpy())), rel=1e-6)
    with pytest.raises(ValueError, match="recompute"):
        ph.aligned_h_train_inv(n0 - 1)


def test_render_gains_matches_jax(handlers):
    """The port's render_gains at the candidates, fed JAX's H_train_inv,
    against the raw gains of JAX's handler (its render_gains programs)."""
    jh_hinv = torch.as_tensor(handlers["j_hinv"][_map_active()])
    cam, params = handlers["cam"], handlers["params"]
    for vec, ref in zip(CANDIDATES, handlers["j_gains"]):
        rot, tran = _w2c_rt(np.linalg.inv(pose_matrix_from_quaternion(vec)))
        g_sil, g_eig, over = render_gains(
            params, None, torch.as_tensor(rot), torch.as_tensor(tran), cam,
            CFG, jh_hinv, SEED)
        assert over is False
        assert abs(float(g_sil) - ref["sil"] / GAINS["k_sil"]) * W * H <= 1.0
        r_eig = ref["eig"] / GAINS["k_eig"]
        assert abs(float(g_eig) - r_eig) <= EIG_RTOL * abs(r_eig)
        _, e0, _ = render_gains(params, None, torch.as_tensor(rot),
                                torch.as_tensor(tran), cam, CFG, None, SEED)
        assert float(e0) == 0.0


def test_render_fisher_matches_jax(handlers):
    """The port's Fisher at a visited pose against JAX's (the handler's
    fisher_h_train program with one pose weighted), over the active rows."""
    import jax.numpy as jnp

    jh, jp = handlers["jh"], handlers["jp"]
    rot, tran = _w2c_rt(np.linalg.inv(_c2w(VISITED[1])))
    rots = np.stack([rot, rot])
    trans = np.stack([tran, tran])
    h_j, over = jh._htrain(jp, jnp.asarray(_map_active()), jnp.asarray(rots),
                           jnp.asarray(trans), jnp.asarray([1.0, 0.0]))
    assert not bool(over)
    h_j = np.asarray(h_j)[_map_active()]
    h_p = render_fisher(handlers["params"], None, torch.as_tensor(rot),
                        torch.as_tensor(tran), handlers["cam"], CFG,
                        seed_value=SEED).numpy()
    scale = np.abs(h_j).max()
    assert np.abs(h_p - h_j).max() <= FISHER_TOL * scale


def test_gain_helpers_match_jax():
    import jax.numpy as jnp

    from splatam_tpu import fisher as jf

    rng = np.random.default_rng(1)
    sil = rng.uniform(0, 1, (32, 48)).astype(np.float32)
    assert float(silhouette_gain(torch.as_tensor(sil), k_sil=2.0)) == \
        pytest.approx(float(jf.silhouette_gain(jnp.asarray(sil), k_sil=2.0)),
                      rel=1e-6)
    hs = [rng.uniform(0, 1, (10, 4)).astype(np.float32) for _ in range(5)]
    np.testing.assert_array_equal(
        h_train_inverse(hs * 20, monte_carlo=40, rng=np.random.default_rng(0)),
        jf.h_train_inverse(hs * 20, monte_carlo=40,
                           rng=np.random.default_rng(0)))
    hinv = h_train_inverse(hs, monte_carlo=None)
    np.testing.assert_allclose(hinv, 1.0 / (np.sum(hs, axis=0) + 0.1),
                               rtol=1e-6)
    score = float(eig_score(torch.as_tensor(hs[0]), torch.as_tensor(hinv)))
    assert score > 0 and score == pytest.approx(
        float(jf.eig_score(jnp.asarray(hs[0]), jnp.asarray(hinv))), rel=1e-6)
    for x in (score, -800.0, 5000.0):
        assert float(nonlinear_gain(x)) == pytest.approx(
            float(jf.nonlinear_gain(jnp.asarray(x))), rel=1e-6, abs=1e-4)
