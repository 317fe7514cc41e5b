#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``splatam_torch``) on one GPU.

Phases, each of which must pass:

1. Build the compositing kernels (B1 ``csrc/raster_fwd.cu``, B2
   ``csrc/raster_bwd.cu``) from this checkout with nvcc, and print the
   toolchain and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card: the
   three golden scenes (whose image outputs are also held against
   ``tests/goldens``), a saturating scene, an empty scene, and ``bench.py``'s
   scene (200k gaussians at 1200x680) with the fused 6-channel mapping
   features. Tolerances: forward atol 1e-5 + rtol 1e-4 (final T atol 2e-5),
   saturation depth exact, gradients 5e-5 of their largest magnitude.
3. Time B1 and B2 on the 200k scene (CUDA events after warm-up) beside
   their plain versions and their bound, and time one full mapping
   iteration (forward + backward + Adam, binning frozen for 10 iterations).
4. Drive the main path: ``splatam_torch.run.synthetic_slam`` at Replica
   width (1200x680, tracking 40 / mapping 60 iterations, window 24,
   keyframe every 5), with the kernels' launch counts set to 0 just before
   and read just after; they must be > 0 and match the iterations run.

The last lines are a JSON line of per-kernel numbers and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py [--frames N]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

CHUNK = 128
FWD_ATOL, FWD_RTOL, FINAL_T_ATOL = 1e-5, 1e-4, 2e-5
GRAD_TOL = 5e-5  # of the largest gradient magnitude (tests/test_pallas.py)
# H100 SXM published peaks (NVIDIA's data sheet, at the 700 W limit): f32
# outside the tensor cores, and HBM bandwidth
F32_PEAK_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# f32 operations per (pixel, instance) pair that the kernels' function
# needs (exp counted as one): alpha 16, transmittance test and weight 4,
# median-depth crossing 2, then 2 per feature channel for the blend. The
# backward replays alpha and the test (19), then gc (2 per channel), the
# suffix, dalpha, d/dopacity and dpower (12), the five geometry rows (16),
# the crossing (2), the feature rows (1 per channel) and the per-pixel sum
# of each gradient row (7 + 1 per channel).
FWD_OPS = (22, 2)  # (constant, per feature channel)
BWD_OPS = (56, 4)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# Scenes (numpy, from fixed seeds)
# ---------------------------------------------------------------------------


def golden_scenes():
    """``tools/make_goldens.py::scenes()`` rebuilt in numpy: same seed and
    draw order. Each is (means, feats, opacities, scales, quats, w, h, k)."""
    rng = np.random.default_rng(11)

    def rand_scene(n, w, h, aniso):
        means = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.7, 0.7, n),
                          rng.uniform(1.0, 4.0, n)], axis=-1).astype(np.float32)
        quats = (rng.normal(size=(n, 4))
                 + np.array([2.0, 0, 0, 0])).astype(np.float32)
        log_s = rng.uniform(-3.4, -2.2, (n, 3 if aniso else 1)).astype(np.float32)
        if not aniso:
            log_s = np.tile(log_s, (1, 3))
        colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        opac = (1 / (1 + np.exp(-rng.normal(0.5, 1.0, n)))).astype(np.float32)
        k = [[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]]
        return means, colors, opac, np.exp(log_s), quats, w, h, k

    return {
        "sparse_iso": rand_scene(48, 96, 64, aniso=False),
        "dense_aniso": rand_scene(256, 96, 64, aniso=True),
        "overlap_deep": rand_scene(128, 64, 48, aniso=False),
    }


def small_scene(kind, seed=3):
    """The saturating and empty scenes of tests/test_torch_raster.py."""
    rng = np.random.default_rng(seed)
    if kind == "saturating":
        n, w, h = 400, 64, 48
        means = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.7, 0.7, n),
                          rng.uniform(0.5, 6.0, n)], -1)
        opac = np.full(n, 0.95)
        scales = np.full((n, 3), 0.25)
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
    else:  # empty: everything behind the camera
        n, w, h = 40, 48, 32
        means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                          -rng.uniform(0.5, 5.0, n)], -1)
        opac = 1 / (1 + np.exp(-rng.uniform(-2, 3.0, n)))
        scales = np.exp(rng.uniform(-3.5, -1.5, (n, 3)))
        quats = rng.normal(0, 1, (n, 4))
    feats = rng.uniform(0, 1, (n, 6))
    k = [[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]]
    f32 = [np.asarray(x, np.float32) for x in (means, feats, opac, scales, quats)]
    return (*f32, w, h, k)


def bench_params(n=200_000, w=1200, h=680, seed=0):
    """``bench.py::make_scene``: a box of small gaussians at depth 1..6."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2.2, 2.2, n), rng.uniform(-1.3, 1.3, n),
                      rng.uniform(1.0, 6.0, n)], axis=-1).astype(np.float32)
    k = [[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]]
    params = {
        "means3D": means,
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": (rng.normal(size=(n, 4))
                             + np.array([2.0, 0, 0, 0])).astype(np.float32),
        "logit_opacities": rng.normal(1.0, 1.0, (n, 1)).astype(np.float32),
        "log_scales": rng.uniform(-5.2, -3.8, (n, 1)).astype(np.float32),
    }
    return params, w, h, k


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def phase_build():
    import torch

    from splatam_torch.render import raster

    t0 = time.time()
    logs = raster.build_kernels()
    log(f"[build] {len(logs)} kernel sources compiled in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        log(f"== nvcc {name}\n{text.strip()}")
    nvcc = subprocess.run([raster._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    log(nvcc or "nvcc --version printed nothing")
    log(f"card: {nvidia_smi_line()}")


class Setup:
    """One view's kernel inputs: the attribute table and its binning."""

    def __init__(self, attrs, binned, grid_x, nfeat):
        self.attrs, self.binned, self.grid_x, self.nfeat = (
            attrs, binned, grid_x, nfeat)

    @property
    def args(self):
        return (self.attrs, self.binned.sorted_gid, self.binned.ranges,
                self.grid_x, CHUNK)


def scene_setup(scene, dev, mapping_feats=False):
    import torch

    from splatam_torch.core.losses import depth_silhouette_colors
    from splatam_torch.core.transforms import normalize
    from splatam_torch.render.binning import RasterConfig, bin_gaussians_csr
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.render.geometry import grid_dims, preprocess
    from splatam_torch.render.raster import pack_attrs

    means, feats, opac, scales, quats, w, h, k = scene
    cam = setup_camera(w, h, k, np.eye(4), device=dev)
    t = {name: torch.as_tensor(x, device=dev) for name, x in
         dict(means=means, feats=feats, opac=opac, scales=scales,
              quats=quats).items()}
    if mapping_feats:  # rgb + depth, silhouette, depth^2 (slam_loss)
        t["feats"] = torch.cat(
            [t["feats"], depth_silhouette_colors(t["means"], cam.viewmatrix)], -1)
    proj = preprocess(t["means"], t["scales"], normalize(t["quats"]), cam)
    binned = bin_gaussians_csr(proj, cam, RasterConfig(chunk=CHUNK),
                               opacities=t["opac"])
    attrs = pack_attrs(proj.means2d, proj.conic, t["opac"], proj.depths,
                       t["feats"])
    return Setup(attrs, binned, grid_dims(cam)[0], t["feats"].shape[1])


def compare_kernels(name, s: Setup, rng, errs):
    """B1 and B2 against their plain versions, in the full setting and in
    the mapping loss's narrowed one (4 gradient channels, no median depth)."""
    import torch

    from splatam_torch.render import raster

    out = {}
    for carry, nfeat in ((True, s.nfeat), (False, min(s.nfeat, 4))):
        c1, a1 = raster.raster_fwd_cuda(*s.args, carry)
        torch.cuda.synchronize()
        c0, a0, evaluated = raster.raster_fwd_plain(*s.args, carry)
        for label, got, ref, atol in (
            ("color", c1, c0, FWD_ATOL), ("median depth", a1[:, 0], a0[:, 0], FWD_ATOL),
            ("final T", a1[:, 1], a0[:, 1], FINAL_T_ATOL),
        ):
            if not torch.allclose(got, ref, atol=atol, rtol=FWD_RTOL):
                fail(f"B1 {name} {label}: max err "
                     f"{(got - ref).abs().max().item():.3g}")
        if not torch.equal(a1[:, 2:], a0[:, 2:]):
            fail(f"B1 {name}: saturation depth differs from the plain version")
        e_fwd = max((c1 - c0).abs().max().item(),
                    (a1[:, :2] - a0[:, :2]).abs().max().item())

        g_color = torch.tensor(rng.normal(size=c0.shape).astype(np.float32),
                               device=c0.device)
        g_color[:, nfeat:] = 0.0
        g_aux = torch.tensor(rng.normal(size=a0.shape).astype(np.float32),
                             device=a0.device)
        g_aux[:, 2:] = 0.0
        if not carry:
            g_aux[:, 0] = 0.0
        g1 = raster.raster_bwd_cuda(*s.args, c1, a1, g_color, g_aux, nfeat, carry)
        torch.cuda.synchronize()
        g0 = raster.raster_bwd_plain(*s.args, c0, a0, g_color, g_aux, nfeat, carry)
        scale = g0.abs().max().item()
        e_bwd = (g1 - g0).abs().max().item()
        if e_bwd > GRAD_TOL * max(scale, 1e-30) and e_bwd > 0:
            fail(f"B2 {name} carry_depth={carry}: max err {e_bwd:.3g} "
                 f"against scale {scale:.3g}")
        errs["B1"] = max(errs["B1"], e_fwd)
        errs["B2"] = max(errs["B2"], e_bwd)
        saturated = int((a0[:, 2, 0] < raster.SAT_INF).sum())
        log(f"[kernels] {name:12s} carry_depth={carry!s:5s} nfeat={nfeat} "
            f"K={s.binned.num_instances} saturated_tiles={saturated} "
            f"B1_err={e_fwd:.3g} B2_err={e_bwd:.3g} B2_err/scale="
            f"{e_bwd / max(scale, 1e-30):.3g}")
        out[carry] = (c0, a0, evaluated)
    return out


def check_goldens(name, scene, dev):
    """rasterize_tiled on the card against the frozen dense renders."""
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.render.render_tiled import rasterize_tiled

    means, feats, opac, scales, quats, w, h, k = scene
    cam = setup_camera(w, h, k, np.eye(4), device=dev)
    res, _ = rasterize_tiled(means, feats, opac, scales, quats, cam,
                             cfg=RasterConfig(chunk=CHUNK), device=dev)
    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
    np.testing.assert_allclose(res.color.cpu().numpy(), g["color"],
                               atol=FWD_ATOL, rtol=FWD_RTOL)
    np.testing.assert_allclose(res.final_t.cpu().numpy(), g["final_t"],
                               atol=FINAL_T_ATOL, rtol=FWD_RTOL)
    np.testing.assert_array_equal(res.radius.cpu().numpy(), g["radius"])
    # the dense goldens sort per pixel, the tiles per tile: median-depth tie
    # flips aside, depth agrees (the bound of tests/test_goldens.py)
    off = float((np.abs(res.depth.cpu().numpy() - g["depth"]) > 1e-3).mean())
    if not off < 0.01:
        fail(f"golden {name}: {off:.3%} of depth pixels off by > 1e-3")


def phase_kernels(dev, bench_size=(200_000, 1200, 680)):
    rng = np.random.default_rng(0)
    errs = {"B1": 0.0, "B2": 0.0}
    for name, scene in golden_scenes().items():
        check_goldens(name, scene, dev)
        compare_kernels(name, scene_setup(scene, dev), rng, errs)
    log("[kernels] golden renders match tests/goldens")
    for kind in ("saturating", "empty"):
        compare_kernels(kind, scene_setup(small_scene(kind), dev), rng, errs)
    # the 200k scene as the mapping loss renders it: isotropic scales,
    # sigmoid opacities, 6 fused channels
    p, w, h, k = bench_params(*bench_size)
    scene = (
        p["means3D"], p["rgb_colors"],
        (1 / (1 + np.exp(-p["logit_opacities"][:, 0]))).astype(np.float32),
        np.tile(np.exp(p["log_scales"]), (1, 3)), p["unnorm_rotations"],
        w, h, k,
    )
    bench = scene_setup(scene, dev, mapping_feats=True)
    outs = compare_kernels("bench_200k", bench, rng, errs)
    return errs, bench, outs


def kernel_bounds(s: Setup, evaluated, nfeat_bwd):
    """(B1, B2) least times in ms on this card for this run's inputs, and
    what bounds each."""
    pairs = int(evaluated.sum())
    n, t, k = s.attrs.shape[0], s.binned.ranges.shape[0], s.binned.num_instances
    block = t * 8 * 256 * 4  # one (T, 8, 256) f32 block
    common = n * 16 * 4 + k * 4 + t * 2 * 4
    fwd_bytes, bwd_bytes = common + 2 * block, common + 4 * block + n * 16 * 4
    fwd_ops = pairs * (FWD_OPS[0] + FWD_OPS[1] * s.nfeat)
    bwd_ops = pairs * (BWD_OPS[0] + BWD_OPS[1] * nfeat_bwd)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_S, ops / F32_PEAK_FLOPS
        return max(tb, to) * 1e3, ("operations" if to >= tb else "bytes")

    return bound(fwd_bytes, fwd_ops), bound(bwd_bytes, bwd_ops), pairs


def phase_timing(bench: Setup, outs, dev):
    """B1/B2 times on the 200k scene in the mapping loss's setting."""
    import torch

    from splatam_torch.render import raster

    carry, nfeat = False, 4
    c0, a0, evaluated = outs[carry]
    rng = np.random.default_rng(1)
    g_color = torch.tensor(rng.normal(size=c0.shape).astype(np.float32), device=dev)
    g_color[:, nfeat:] = 0.0
    g_aux = torch.zeros_like(a0)
    g_aux[:, 1] = torch.tensor(rng.normal(size=a0[:, 1].shape).astype(np.float32),
                               device=dev)
    fwd = lambda: raster.raster_fwd_cuda(*bench.args, carry)  # noqa: E731
    bwd = lambda: raster.raster_bwd_cuda(  # noqa: E731
        *bench.args, c0, a0, g_color, g_aux, nfeat, carry)
    fwd_plain = lambda: raster.raster_fwd_plain(*bench.args, carry)  # noqa: E731
    bwd_plain = lambda: raster.raster_bwd_plain(  # noqa: E731
        *bench.args, c0, a0, g_color, g_aux, nfeat, carry)
    times = {
        "B1": (cuda_ms(fwd, 20), cuda_ms(fwd_plain, 2, warmup=0)),
        "B2": (cuda_ms(bwd, 20), cuda_ms(bwd_plain, 2, warmup=0)),
    }
    (b1, b1_by), (b2, b2_by), pairs = kernel_bounds(bench, evaluated, nfeat)
    bounds = {"B1": (b1, b1_by), "B2": (b2, b2_by)}
    for kname in ("B1", "B2"):
        ms, plain = times[kname]
        log(f"[timing] {kname}: {ms:.4f} ms kernel, {plain:.2f} ms plain, "
            f"bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]}), "
            f"K={bench.binned.num_instances} instances, {pairs} (pixel, "
            f"instance) pairs evaluated")
    return times, bounds


def phase_iteration(dev, iters=10, bench_size=(200_000, 1200, 680)):
    """One mapping iteration (render + loss + backward + Adam) on the 200k
    scene, binning frozen for ``iters`` iterations and capped at the
    previous render's saturation depth (bench.py's loop)."""
    import torch

    from splatam_torch.core.losses import compute_binned
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.slam.mapping import init_mapping_optimizer, map_step

    params_np, w, h, k = bench_params(*bench_size)
    params = {key: torch.as_tensor(v, device=dev) for key, v in params_np.items()}
    cam = setup_camera(w, h, k, np.eye(4), device=dev)
    cfg = RasterConfig(chunk=CHUNK)
    rot = torch.tensor([1.0, 0, 0, 0], device=dev)
    tran = torch.zeros(3, device=dev)
    gt_im = torch.zeros((3, h, w), device=dev)
    gt_depth = torch.full((1, h, w), 2.5, device=dev)
    lrs = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "unnorm_rotations": 1e-3,
           "logit_opacities": 0.05, "log_scales": 1e-3}
    opt = init_mapping_optimizer(params)
    sat = [None]

    def block():
        binned = compute_binned(params, rot, tran, cam, cfg, depth_cap=sat[0])
        for _ in range(iters):
            res = map_step(params, opt, rot, tran, gt_im, gt_depth, cam, cfg,
                           lrs=lrs, binned=binned)
            sat[0] = res.sat_depth
        return res

    res = block()  # warm-up; sets the saturation caps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = block()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    if not all(bool(torch.isfinite(v)) for v in res.losses.values()):
        fail("mapping iteration on the 200k scene gave a non-finite loss")
    mpix_s = w * h / (ms * 1e-3) / 1e6
    log(f"[iteration] 200k gaussians at {w}x{h}: {ms:.3f} ms per forward + "
        f"backward + Adam iteration (binning frozen for {iters}), "
        f"{mpix_s:.2f} Mpix/s; library_ms none (no single PyTorch call "
        f"computes this function)")
    if dev.type == "cuda":
        profile_block(block, iters)
    return ms, mpix_s


def profile_block(block, iters, top=12):
    """Where one block of iterations spends the device's time: the share of
    the wall time the device was busy, and the costliest device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets): the host ops that
    # launched them report the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if not rows:
        log("[profile] the profiler saw no device time")
        return
    log(f"[profile] {iters} iterations: wall {wall_ms:.2f} ms under the "
        f"profiler, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(r[2] for r in rows)} device ops")
    for key, dev_ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[profile]   {dev_ms / iters:8.4f} ms/iter  {dev_ms / busy_ms:6.1%}  "
            f"x{count / iters:g}/iter  {key[:90]}")


def phase_slam(frames, device, width=1200, height=680, track=40, map_=60):
    """The main path through the CLI's entry points, at Replica width,
    with Replica's iterations (tracking 40, mapping 60, window 24)."""
    from splatam_torch.render import raster
    from splatam_torch.run import synthetic_slam

    args = synthetic_slam.parse_args([
        "--width", str(width), "--height", str(height), "--frames",
        str(frames), "--track_iters", str(track), "--map_iters", str(map_),
        "--window", "24", "--device", str(device),
    ])
    raster.FWD_KERNEL.launches = 0
    raster.BWD_KERNEL.launches = 0
    result, state = synthetic_slam.run(args)
    launches = {"B1": raster.FWD_KERNEL.launches,
                "B2": raster.BWD_KERNEL.launches}
    log(f"[slam] {json.dumps(result)}")
    c = state.counts
    iters = c["tracking_iters"] + c["mapping_iters"]
    # every iteration renders once and backpropagates once; B1 also renders
    # each dataset frame, each densification check and each evaluated frame
    expect_b1 = iters + c["densify_renders"] + 2 * frames
    tm = state.timing
    log(f"[slam] mean ms per iteration: tracking "
        f"{1e3 * np.mean(tm['tracking_iter']):.2f}, mapping "
        f"{1e3 * np.mean(tm['mapping_iter']):.2f}; last frame: tracking "
        f"{tm['tracking_frame'][-1]:.2f} s, mapping {tm['mapping_frame'][-1]:.2f} s")
    log(f"[slam] launches B1={launches['B1']} B2={launches['B2']}; iterations "
        f"tracking={c['tracking_iters']} mapping={c['mapping_iters']}, "
        f"densify renders={c['densify_renders']}, frames={frames}")
    if launches["B2"] == 0 or launches["B1"] == 0:
        fail("the main path launched no kernel")
    if launches["B2"] != iters or launches["B1"] != expect_b1:
        fail(f"launch counts {launches} do not match the run: expected "
             f"B2={iters}, B1={expect_b1}")
    if (c["tracking_iters"] != track * (frames - 1)
            or c["mapping_iters"] != map_ * frames):
        fail(f"iterations run {c} are not {track}/{map_} per frame")
    for key in ("ate_m", "psnr", "depth_l1_m"):
        if not math.isfinite(result[key]):
            fail(f"SLAM {key} is not finite: {result[key]}")
    # bounds: ATE that of tests/test_slam.py's synthetic regression; the
    # map reproduces its own frames to well above 20 dB and 5 cm depth
    if not (result["ate_m"] < 0.03 and result["psnr"] > 20.0
            and result["depth_l1_m"] < 0.05):
        fail(f"SLAM quality out of bounds: {result}")
    if any(state.nonfinite.values()):
        fail(f"non-finite iterations: {state.nonfinite}")
    return result, launches


def smoke(dev, frames, bench_size=(200_000, 1200, 680), slam_size=None):
    """Phases 2-4 on ``dev``. Returns (the kernels' JSON entries, a
    one-line summary)."""
    import torch

    t = time.time()
    errs, bench, outs = phase_kernels(dev, bench_size)
    log(f"[kernels] all comparisons within tolerance ({time.time() - t:.1f} s)")
    t = time.time()
    times, bounds = phase_timing(bench, outs, dev)
    del bench, outs
    torch.cuda.empty_cache()
    it_ms, mpix_s = phase_iteration(dev, bench_size=bench_size)
    log(f"[timing] done ({time.time() - t:.1f} s)")
    t = time.time()
    slam, launches = phase_slam(frames, dev, **(slam_size or {}))
    log(f"[slam] {frames} frames in {time.time() - t:.1f} s")

    replaces = {
        "B1": "splatam_tpu/render/pallas_raster.py:567",
        "B2": "splatam_tpu/render/pallas_raster.py:962",
    }
    sources = {
        "B1": ("raster_fwd", "splatam_torch/render/csrc/raster_fwd.cu"),
        "B2": ("raster_bwd", "splatam_torch/render/csrc/raster_bwd.cu"),
    }
    kernels = [
        {
            "name": sources[k][0], "route": "cuda", "source": sources[k][1],
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": None,
        }
        for k in ("B1", "B2")
    ]
    summary = (f"iteration {it_ms:.3f} ms ({mpix_s:.2f} Mpix/s); "
               f"SLAM {slam['s_per_frame']} s/frame")
    return kernels, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=100,
                   help="SLAM frames at 1200x680 (at least 3)")
    args = p.parse_args(argv)
    if args.frames < 3:
        fail("--frames must be at least 3")

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on a GPU")
    sys.path.insert(0, ROOT)
    try:
        import splatam_torch  # noqa: F401
    except ImportError as e:
        fail(f"splatam_torch is not importable next to this script: {e}")
    if not os.path.isdir(os.path.join(ROOT, "tests", "goldens")):
        fail("tests/goldens is missing: run from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    phase_build()
    kernels, summary = smoke(torch.device("cuda"), args.frames)
    log(f"[total] {time.time() - t_start:.1f} s; {summary}")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
