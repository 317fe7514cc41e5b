"""The port's multi-device modules (``splatam_torch/parallel/``).

The partitions against the JAX package's numpy functions; the per-band
body, every band rendered in turn and assembled, against ``tests/goldens``
and the port's unsharded path; the collectives in one spawn of 4 gloo
ranks against the same computations in one process; ``batched_map_step``
against the JAX package's at the multi-chip dry run's toy size.

This module imports no JAX at import time: the spawned gloo ranks import
it again.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from chip_smoke import golden_scenes
from splatam_torch.core.losses import compute_binned
from splatam_torch.core.optim import init_adam
from splatam_torch.core.params import GAUSSIAN_KEYS
from splatam_torch.core.transforms import normalize
from splatam_torch.parallel.mesh import Mesh, make_mesh, maybe_initialize_distributed
from splatam_torch.parallel.pallas_sharded import (
    band_partition,
    equal_bands,
    grid_partition,
    rasterize_bands,
    rasterize_rows_sharded,
    row_loads_from_counts,
)
from splatam_torch.parallel.prim_sharded import (
    gathered_bytes_per_gaussian,
    render_prim_sharded,
    render_prim_shards,
    shard_slices,
)
from splatam_torch.parallel.sharded import batched_map_step
from splatam_torch.render.binning import RasterConfig
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.render_tiled import rasterize_tiled

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GRAD_TOL = 2e-5  # of scale: tests/test_sharded_pallas.py's bound
LRS = (("log_scales", 0.001), ("logit_opacities", 0.05),
       ("means3D", 0.0001), ("rgb_colors", 0.0025),
       ("unnorm_rotations", 0.001))
WORLD = 4


# ---------------------------------------------------------------------------
# Scenes (numpy, from seeds)
# ---------------------------------------------------------------------------


def toy_scene(n=512, w=128, h=96, seed=0):
    """``__graft_entry__._toy_scene`` in numpy: (params, camera args)."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
         rng.uniform(0.8, 4.0, n)], axis=-1).astype(np.float32)
    k = [[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]]
    params = {
        "means3D": means,
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": rng.normal(1.0, 0.5, (n, 1)).astype(np.float32),
        "log_scales": rng.uniform(-3.2, -2.2, (n, 1)).astype(np.float32),
    }
    return params, (w, h, k)


def band_scene(seed=2, n=120, w=128, h=144):
    """tests/test_sharded_pallas.py's concentrated scene: content in the
    image's upper third, so the row loads are unequal."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.8, -0.2, n),
                      rng.uniform(0.8, 4.0, n)], axis=-1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.uniform(-2, 3, n)))).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, -1.5, (n, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    k = [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]]
    cot = rng.normal(size=(3, h, w)).astype(np.float32)
    return (means, colors, opac, scales, quats), (w, h, k), cot


def prim_scene(n=256, w=64, h=48, seed=0):
    """tests/test_prim_sharded.py's scene at toy size: anisotropic, so the
    rotation gradients are signal; a tenth of the rows inactive."""
    rng = np.random.default_rng(seed)
    params = {
        "means3D": np.stack([rng.uniform(-0.8, 0.8, n),
                             rng.uniform(-0.6, 0.6, n),
                             rng.uniform(1.2, 4.0, n)], -1).astype(np.float32),
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": (rng.normal(size=(n, 4))
                             + np.array([2.0, 0, 0, 0])).astype(np.float32),
        "logit_opacities": rng.normal(0.5, 1.0, (n, 1)).astype(np.float32),
        "log_scales": rng.uniform(-3.0, -2.0, (n, 3)).astype(np.float32),
    }
    active = rng.uniform(size=n) > 0.1
    k = [[55.0, 0, w / 2], [0, 55.0, h / 2], [0, 0, 1]]
    pose = (np.array([0.999, 0.02, -0.01, 0.03], np.float32),
            np.array([0.01, -0.02, 0.05], np.float32))
    cot = rng.normal(size=(6, h, w)).astype(np.float32)
    return params, active, (w, h, k), pose, cot


def batch_inputs(b=2, n=256, w=96, h=64):
    """``__graft_entry__.dryrun_multichip``'s training-step inputs."""
    params, cam_args = toy_scene(n=n, w=w, h=h)
    params["cam_unnorm_rots"] = np.tile(
        np.array([1, 0, 0, 0], np.float32)[None, :, None], (1, 1, 4))
    params["cam_trans"] = np.zeros((1, 3, 4), np.float32)
    rng = np.random.default_rng(1)
    rots = (np.tile(np.array([1, 0, 0, 0], np.float32), (b, 1))
            + 0.01 * rng.normal(size=(b, 4)).astype(np.float32))
    trans = (0.01 * rng.normal(size=(b, 3))).astype(np.float32)
    ims = rng.uniform(0, 1, (b, 3, h, w)).astype(np.float32)
    depths = rng.uniform(0.5, 3.0, (b, 1, h, w)).astype(np.float32)
    return params, cam_args, (rots, trans, ims, depths)


def _leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _cam(cam_args):
    w, h, k = cam_args
    return setup_camera(w, h, k, np.eye(4), device="cpu")


def _scaled_close(got, ref, tol, label):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               atol=tol, err_msg=label)


# ---------------------------------------------------------------------------
# The computations the gloo ranks run, and their in-process counterparts
# ---------------------------------------------------------------------------

BANDS = np.array([0, 2, 3, 4, 9], np.int32)  # unequal rows of band_scene
GRID = (np.array([0, 3, 9], np.int32), np.array([0, 5, 8], np.int32))


def _band_loss(out, cot):
    return (out.color * torch.tensor(cot)).sum() + out.final_t.sum()


def _run_bands(mesh, layout, grid):
    arrays, cam_args, cot = band_scene()
    cam = _cam(cam_args)
    cfg = RasterConfig(chunk=64, layout=layout)
    t = _leaves(arrays)
    if mesh is None:
        rb, cb = GRID if grid else (BANDS, None)
        out, aux, _ = rasterize_bands(t[0], t[1], t[2], t[3], normalize(t[4]),
                                      cam, cfg, rb, cb)
    elif grid:
        out, aux = rasterize_rows_sharded(
            t[0], t[1], t[2], t[3], normalize(t[4]), cam, cfg, mesh,
            axis_name="ty", band_starts=GRID[0], col_starts=GRID[1],
            axis_name_x="tx")
    else:
        out, aux = rasterize_rows_sharded(
            t[0], t[1], t[2], t[3], normalize(t[4]), cam, cfg, mesh,
            band_starts=BANDS)
    _band_loss(out, cot).backward()
    res = {"color": out.color, "final_t": out.final_t, "depth": out.depth,
           "sat": aux.sat_depth, "instances": torch.tensor(aux.num_instances)}
    for name, x in zip(("means", "colors", "opac", "scales", "quats"), t):
        res["g_" + name] = x.grad
    return res


def _run_prims(rank, world):
    params, active, cam_args, pose, cot = prim_scene()
    cam = _cam(cam_args)
    cfg = RasterConfig(chunk=64)
    rot, tran = (torch.tensor(x, requires_grad=True) for x in pose)
    slices = shard_slices(params["means3D"].shape[0], world)
    shards = [{k: torch.tensor(v[s], requires_grad=True)
               for k, v in params.items()} for s in slices]
    actives = [torch.tensor(active[s]) for s in slices]
    if rank is None:
        out, aux, records = render_prim_shards(shards, actives, rot, tran, cam,
                                               cfg)
        mine = shards
    else:
        mesh = Mesh({"prims": world})
        out, aux = render_prim_sharded(shards[rank], actives[rank], rot, tran,
                                       cam, cfg, mesh)
        mine = [shards[rank]]
    (out.color * torch.tensor(cot)).sum().add(out.final_t.sum()).backward()
    res = {"color": out.color, "depth": out.depth, "final_t": out.final_t,
           "instances": torch.tensor(aux.num_instances), "g_rot": rot.grad,
           "g_tran": tran.grad}
    for k in GAUSSIAN_KEYS:
        res["g_" + k] = torch.cat([s[k].grad for s in mine])
    return res


def _run_batched(mesh):
    params, cam_args, (rots, trans, ims, depths) = batch_inputs()
    tp = {k: torch.tensor(v) for k, v in params.items()}
    n = tp["means3D"].shape[0]
    active = torch.ones(n, dtype=torch.bool)
    active[::7] = False
    opt = init_adam({k: tp[k] for k in GAUSSIAN_KEYS})
    cfg = RasterConfig(chunk=64, shard_axis="tiles")
    _, opt, loss = batched_map_step(
        tp, active, opt, torch.tensor(rots), torch.tensor(trans),
        torch.tensor(ims), torch.tensor(depths), _cam(cam_args), cfg, LRS,
        mesh=mesh)
    res = {"loss": loss}
    for k in GAUSSIAN_KEYS:
        res[k], res["mu_" + k], res["nu_" + k] = tp[k], opt.mu[k], opt.nu[k]
    return res


def _numpy(res):
    return {k: v.detach().numpy() for k, v in res.items()}


def _gloo_rank(rank, world, init_file, out_dir):
    """One gloo rank: every collective check, its results saved for the
    parent to compare."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        res = {}
        rows = Mesh({"data": 1, "tiles": world})
        grid = Mesh({"ty": 2, "tx": world // 2})
        for layout in ("aligned", "split"):
            for k, v in _numpy(_run_bands(rows, layout, False)).items():
                res[f"rows_{layout}_{k}"] = v
        for k, v in _numpy(_run_bands(grid, "split", True)).items():
            res[f"grid_{k}"] = v
        for k, v in _numpy(_run_prims(rank, world)).items():
            res[f"prim_{k}"] = v
        mesh = make_mesh(n_tiles=2, n_data=world // 2)
        for k, v in _numpy(_run_batched(mesh)).items():
            res[f"batch_{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One spawn of WORLD gloo ranks; their saved results, per rank."""
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_gloo_rank, args=(WORLD, str(d / "init"), str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# Partitions
# ---------------------------------------------------------------------------


def _partition_cases():
    rng = np.random.default_rng(5)
    conc = np.array([0, 0, 5, 40, 90, 120, 110, 80, 30, 5, 0, 0])
    return {
        # tests/test_sharded_pallas.py:86-107's concentrated rows
        "concentrated": (np.tile(conc[:, None], (1, 5)), 5),
        "random": (rng.integers(0, 400, (12, 7)), 7),
        "sparse": (rng.integers(0, 3, (9, 4)) * rng.integers(0, 50, (9, 4)), 4),
    }


@pytest.mark.parametrize("case", ["concentrated", "random", "sparse"])
def test_partitions_match_jax(case):
    """band_partition, row_loads_from_counts and grid_partition equal the
    JAX package's (host numpy, no compile) for every device count."""
    from splatam_tpu.parallel import pallas_sharded as jps

    loads2d, grid_x = _partition_cases()[case]
    counts = loads2d.reshape(-1)
    rows = row_loads_from_counts(counts, grid_x)
    np.testing.assert_array_equal(rows, jps.row_loads_from_counts(counts, grid_x))
    for ndev in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(band_partition(rows, ndev),
                                      jps.band_partition(rows, ndev))
        got, ref = grid_partition(counts, grid_x, ndev), jps.grid_partition(
            counts, grid_x, ndev)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    if case == "concentrated":  # the JAX test's own bound
        conc = loads2d[:, 0]
        b = band_partition(conc, 8)
        band_loads = [conc[b[d]: b[d + 1]].sum() for d in range(8)]
        assert max(band_loads) / (conc.sum() / 8) <= 2.01


def test_grid_partition_reproduces_multichip_table():
    """The port's binning counts on the dry run's scene (4096 gaussians at
    256x192, identity pose, chunk 128) give MULTICHIP_r05.json's
    SCALING_TABLE: the 2x4 grid's cell loads and imbalances."""
    params, cam_args = toy_scene(n=4096, w=256, h=192, seed=2)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    binned = compute_binned(tp, torch.tensor([1.0, 0, 0, 0]), torch.zeros(3),
                            _cam(cam_args), RasterConfig(chunk=128))
    counts = binned.counts.numpy()
    rb, cb, cells = grid_partition(counts, 16, 8)
    assert list(cells.shape) == [2, 4]
    assert cells.reshape(-1).tolist() == [6742, 5778, 5644, 6461, 6407, 5874,
                                          5758, 6545]
    mean = counts.sum() / 8
    assert round(cells.max() / mean, 3) == 1.096
    loads = row_loads_from_counts(counts, 16)
    b = band_partition(loads, 8)
    assert round(max(loads[b[d]: b[d + 1]].sum() for d in range(8)) / mean,
                 3) == 1.489
    eq = equal_bands(12, 8)
    assert [int(loads[eq[d]: eq[d + 1]].sum()) for d in range(8)] == [
        5537, 8982, 10106, 10061, 9156, 5367, 0, 0]


# ---------------------------------------------------------------------------
# Bands in one process
# ---------------------------------------------------------------------------


def _bounds(kind, counts, grid_x, grid_y):
    if kind == "equal":
        return equal_bands(grid_y, 3), None
    if kind == "balanced":
        return band_partition(row_loads_from_counts(counts, grid_x), 3), None
    rb, cb, _ = grid_partition(counts, grid_x, 4)
    return rb, cb


@pytest.mark.parametrize("layout", ["aligned", "split"])
@pytest.mark.parametrize("kind", ["equal", "balanced", "grid"])
def test_bands_match_goldens_and_unsharded(kind, layout):
    """Every band (cell) through the per-band body, assembled: the golden
    renders at atol 1e-5 / rtol 1e-4, and the unsharded render's gradients
    at 2e-5 of scale."""
    cfg = RasterConfig(chunk=64, layout=layout)
    for name, scene in golden_scenes().items():
        arrays, (w, h, k) = scene[:5], scene[5:]
        cam = _cam((w, h, k))
        cot = torch.tensor(np.random.default_rng(3).normal(
            size=(3, h, w)).astype(np.float32))
        ref_t = _leaves(arrays)
        ref, ref_aux = rasterize_tiled(ref_t[0], ref_t[1], ref_t[2], ref_t[3],
                                       normalize(ref_t[4]), cam, cfg=cfg,
                                       device="cpu")
        _band_loss(ref, cot.numpy()).backward()
        counts = compute_binned_counts(arrays, cam)
        rb, cb = _bounds(kind, counts, (w + 15) // 16, (h + 15) // 16)
        t = _leaves(arrays)
        out, aux, loads = rasterize_bands(t[0], t[1], t[2], t[3],
                                          normalize(t[4]), cam, cfg, rb, cb)
        _band_loss(out, cot.numpy()).backward()
        g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
        np.testing.assert_allclose(out.color.detach().numpy(), g["color"],
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(out.final_t.detach().numpy(), g["final_t"],
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_array_equal(out.radius.numpy(), g["radius"])
        # the dense goldens sort per pixel, the tiles per tile: median-depth
        # tie flips aside, depth agrees (tests/test_goldens.py's bound)
        assert (np.abs(out.depth.detach().numpy() - g["depth"]) > 1e-3
                ).mean() < 0.01
        np.testing.assert_allclose(out.depth.detach().numpy(),
                                   ref.depth.detach().numpy(), atol=1e-5)
        assert aux.num_instances == ref_aux.num_instances == sum(
            n for _, _, n in loads)
        assert torch.equal(aux.sat_depth, ref_aux.sat_depth)
        joint = max(float(r.grad.abs().max()) for r in ref_t)
        for a, r, label in zip(t, ref_t, ("means", "colors", "opac", "scales",
                                          "quats")):
            scale = float(r.grad.abs().max())
            if label == "quats" and name != "dense_aniso":
                # isotropic: the quaternion gradients are rounding noise,
                # held at the scale of all the gradients
                scale = joint
            np.testing.assert_allclose(a.grad.numpy() / scale,
                                       r.grad.numpy() / scale, atol=GRAD_TOL,
                                       err_msg=f"{name} {label}")


def compute_binned_counts(arrays, cam):
    """The aligned binning's (T,) counts of a numpy scene."""
    from splatam_torch.render.binning import bin_gaussians_csr
    from splatam_torch.render.geometry import preprocess

    means, _, opac, scales, quats = (torch.tensor(a) for a in arrays)
    proj = preprocess(means, scales, normalize(quats), cam)
    return bin_gaussians_csr(proj, cam, RasterConfig(layout="aligned"),
                             opacities=opac).counts.numpy()


def test_one_rank_mesh_without_process_group():
    """No env, no process group: maybe_initialize_distributed does nothing,
    and the 1x1 mesh's sharded render is the unsharded one."""
    env = {k: os.environ.pop(k) for k in (
        "WORLD_SIZE", "SPLATAM_TPU_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
        if k in os.environ}
    try:
        assert maybe_initialize_distributed("cpu") is False
        assert not dist.is_initialized()
    finally:
        os.environ.update(env)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "tiles": 1} and mesh.group("tiles") is None
    arrays, cam_args, cot = band_scene()
    cam = _cam(cam_args)
    for layout in ("aligned", "split"):
        cfg = RasterConfig(chunk=64, layout=layout)
        ref, ref_aux = rasterize_tiled(*arrays[:4], normalize(
            torch.tensor(arrays[4])), cam, cfg=cfg, device="cpu")
        t = [torch.tensor(a) for a in arrays]
        out, aux = rasterize_rows_sharded(t[0], t[1], t[2], t[3],
                                          normalize(t[4]), cam, cfg, mesh)
        for f in ("color", "final_t", "depth"):
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
        assert aux.num_instances == ref_aux.num_instances
    assert gathered_bytes_per_gaussian()["gathered_record_bytes"] == 19 * 4


# ---------------------------------------------------------------------------
# Collectives: one spawn of 4 gloo ranks
# ---------------------------------------------------------------------------


def _hold_render(got, ref, prefix):
    for f in ("color", "final_t", "depth"):
        np.testing.assert_allclose(got[f"{prefix}{f}"], ref[f], atol=1e-6,
                                   err_msg=prefix + f)
    assert int(got[f"{prefix}instances"]) == int(ref["instances"])


@pytest.mark.parametrize("layout", ["aligned", "split"])
def test_gloo_rows_sharded(gloo, layout):
    """rasterize_rows_sharded over a 1x4 tiles group, unequal bands: every
    rank's image and its (all-reduced) gradients equal the bands rendered
    in turn here."""
    ref = _numpy(_run_bands(None, layout, False))
    for rank, got in enumerate(gloo):
        p = f"rows_{layout}_"
        _hold_render(got, ref, p)
        np.testing.assert_array_equal(got[p + "sat"], ref["sat"])
        for k in ("means", "colors", "opac", "scales", "quats"):
            _scaled_close(got[p + "g_" + k], ref["g_" + k], GRAD_TOL,
                          f"rank {rank} {k}")


def test_gloo_grid_sharded(gloo):
    """A 2x2 grid of cells over two mesh axes, split layout."""
    ref = _numpy(_run_bands(None, "split", True))
    for rank, got in enumerate(gloo):
        _hold_render(got, ref, "grid_")
        for k in ("means", "colors", "opac", "scales", "quats"):
            _scaled_close(got["grid_g_" + k], ref["g_" + k], GRAD_TOL,
                          f"rank {rank} {k}")


def test_gloo_prim_sharded(gloo):
    """render_prim_sharded over 4 prims: the image on every rank, each
    rank's parameter gradients its shard's slice, the pose gradients
    summed; all equal the 4 shards' records concatenated here."""
    ref = _numpy(_run_prims(None, WORLD))
    n = ref["g_means3D"].shape[0]
    for rank, (got, s) in enumerate(zip(gloo, shard_slices(n, WORLD))):
        _hold_render(got, ref, "prim_")
        for k in GAUSSIAN_KEYS:
            _scaled_close(got["prim_g_" + k], ref["g_" + k][s], GRAD_TOL,
                          f"rank {rank} {k}")
        for k in ("g_rot", "g_tran"):
            _scaled_close(got["prim_" + k], ref[k], GRAD_TOL, f"rank {rank} {k}")


def test_prim_shards_match_unsharded():
    """The 4 shards' records render the map as the port's unsharded fused
    render does, with its gradients."""
    from splatam_torch.core.losses import render_for_loss

    params, active, cam_args, pose, cot = prim_scene()
    cam = _cam(cam_args)
    got = _numpy(_run_prims(None, WORLD))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    rot, tran = (torch.tensor(x, requires_grad=True) for x in pose)
    out, aux = render_for_loss(tp, rot, tran, cam, RasterConfig(chunk=64),
                               gaussians_grad=True, camera_grad=True,
                               active=torch.tensor(active))
    (out.color * torch.tensor(cot)).sum().add(out.final_t.sum()).backward()
    np.testing.assert_allclose(got["color"], out.color.detach().numpy(),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["final_t"], out.final_t.detach().numpy(),
                               atol=1e-5, rtol=1e-4)
    assert int(got["instances"]) == aux.num_instances
    for k in GAUSSIAN_KEYS:
        _scaled_close(got["g_" + k], tp[k].grad.numpy(), GRAD_TOL, k)
    _scaled_close(got["g_rot"], rot.grad.numpy(), GRAD_TOL, "rot")
    _scaled_close(got["g_tran"], tran.grad.numpy(), GRAD_TOL, "tran")


def test_gloo_batched_map_step(gloo):
    """batched_map_step over a 2x2 (data, tiles) mesh: every rank takes the
    step the whole batch takes here (renders unsharded)."""
    ref = _numpy(_run_batched(None))
    for rank, got in enumerate(gloo):
        for k, v in ref.items():
            _scaled_close(got["batch_" + k], v, GRAD_TOL, f"rank {rank} {k}")


def test_batched_map_step_matches_jax():
    """The dry run's step (n=256 at 96x64, B=2, chunk 64,
    shard_axis='tiles') against the JAX package's, jnp backend on a 1x2
    virtual mesh: new parameters, Adam moments and loss to 5e-5 of scale."""
    import jax
    import jax.numpy as jnp

    from splatam_tpu.core.optim import init_adam as jinit
    from splatam_tpu.parallel.mesh import make_mesh as jmesh
    from splatam_tpu.parallel.sharded import batched_map_step as jstep
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.camera import setup_camera as jcam

    params, (w, h, k), (rots, trans, ims, depths) = batch_inputs()
    n = params["means3D"].shape[0]
    active = np.ones(n, bool)
    active[::7] = False
    jparams = {key: jnp.asarray(v) for key, v in params.items()}
    cfg = JCfg(max_instances=2**14, max_per_tile=256, chunk=64,
               shard_axis="tiles")
    with jax.set_mesh(jmesh(n_tiles=2, n_data=1, devices=jax.devices()[:2])):
        new, opt, loss = jstep(
            jparams, jnp.asarray(active),
            jinit({key: jparams[key] for key in GAUSSIAN_KEYS}),
            jnp.asarray(rots), jnp.asarray(trans), jnp.asarray(ims),
            jnp.asarray(depths), jcam(w, h, k, np.eye(4)), cfg, lrs=LRS)
    got = _numpy(_run_batched(None))
    _scaled_close(got["loss"], np.asarray(loss), 5e-5, "loss")
    for key in GAUSSIAN_KEYS:
        _scaled_close(got[key], np.asarray(new[key]), 5e-5, key)
        if float(np.abs(np.asarray(opt.mu[key])).max()) > 0:
            _scaled_close(got["mu_" + key], np.asarray(opt.mu[key]), 5e-5,
                          "mu " + key)
            _scaled_close(got["nu_" + key], np.asarray(opt.nu[key]), 5e-5,
                          "nu " + key)
        else:  # isotropic: the rotations never reach the loss
            assert not got["mu_" + key].any() and not got["nu_" + key].any()
