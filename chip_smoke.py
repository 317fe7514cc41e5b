#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``splatam_torch``) on one GPU.

Phases, each of which must pass:

1. Build the kernels from this checkout with nvcc, one process per source,
   all at once: aligned layout B1 ``csrc/raster_fwd.cu`` and B2
   ``csrc/raster_bwd.cu``; split layout B3a/B3b ``csrc/raster_split_fwd.cu``
   and B3c/B3d ``csrc/raster_split_bwd.cu``; the Fisher moments B4
   ``csrc/raster_fisher.cu``; the measurement probes P1-P4
   ``csrc/probe_ablate.cu``, ``probe_ops.cu``, ``probe_ilp.cu``,
   ``probe_step.cu``, and B1's stage probe ``probe_fwd.cu``. Print the toolchain (and whether Triton imports) and
   the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card: the
   three golden scenes (whose image outputs are also held against
   ``tests/goldens``), a saturating scene, an empty scene, the far-mean
   and contention scene (``far_contention``: large gaussians whose means
   lie 100-600 px off the tiles they cover, one covering every tile, a
   saturating stack), the alpha-floor scene (``threshold``: faint wide
   gaussians with op exp(power) within 2% of 1/255 at many pixels), and
   ``bench.py``'s scene (200k gaussians at 1200x680) with the fused
   6-channel mapping features; B3a-d also on an interior-only scene. B1,
   B2, B3a-d and B4 also at chunk 256 and 512 (past 48 KB of shared
   memory for the backward and B4) on every scene. Each split kernel gets
   the plain version's inputs (carries included); B3b, which finishes its
   tiles in place, runs on the plain B3a's outputs and is held against
   ``compose_split`` of the plain B3a's and B3b's. The split render on the
   card and its gradients are held against B1/B2 on the same scene.
   Tolerances: forward atol 1e-5 + rtol 1e-4 (final T atol 2e-5 against
   the plain versions, 1e-6 split against aligned), saturation depth
   exact, gradients 5e-5 of their largest magnitude. B4 (aligned binning,
   seed 1e-3 on RGB) on the same scenes against its plain version: each
   moment column within 1e-4 of that column's largest magnitude; and
   ``render_fisher`` on the card against the plain path on the CPU on a
   golden scene, within 1e-4 of the Fisher's largest magnitude.
3. Time every kernel on the 200k scene (CUDA events after warm-up) beside
   its plain version and its bound (B4 with its registers and blocks per
   SM from the CUDA runtime), and time one SLAM mapping iteration
   (``map_step``: forward + backward + Adam at chunk 128, binning frozen
   for 10 iterations) in each layout.
4. ``[bench]``: B1-B3d at chunk 256 on the benchmark's own trimmed streams
   against their plain versions; then ``python -m splatam_torch.bench``
   (``bench.py``'s program: 200k gaussians at 1200x680, gradient only,
   chunk 256, 10 iterations binned once) in the split and the aligned
   layout, with exact launch counts (per layout: the trim probe's forward,
   then 10 iterations of warm-up and 10 timed); its JSON line, the
   iteration ms and the trimmed instance count, the loss finite; then the
   top device ops of each run.
5. ``[probes]``: P1 (B2's stages, ``full`` against B2 within GRAD_TOL, the
   other stages per pixel at 1e-5 + 1e-4 rel, on the bench's aligned
   stream), P2 (every op and dtype at reps 3: f32 at 1e-5 + 1e-4 rel, bf16
   exactly), P3 (every case at reps 0, 1 and 4, within 1e-4 of each
   output's largest magnitude) and P4 (every body, 1e-4 of
   the output's largest magnitude) against their plain versions at the
   tools' default sizes; then each probe's run as the main path, with
   exact launch counts, printing the tools' tables and the rates against
   the card's peaks. Then ``[fwd_stages]``: B1's stage probe
   (``splatam_torch.bench.fwd_stages``: B1 cut after each stage, built
   from B1's helpers) on ``[timing]``'s B1 stream, its last stage held to
   B1's plain version.
6. The SLAM path: ``splatam_torch.run.synthetic_slam`` at Replica width
   (1200x680, tracking 40 / mapping 60 iterations, window 24, keyframe
   every 5, 60 frames), with every kernel's launch count set to 0 just
   before and read just after; they must match what each call site runs
   (frame 0 resolves the SLAM renders' layout; the evaluation renders are
   split, the dataset's ground-truth renders aligned).
7. The offline path: ``splatam_torch.gs.offline.offline_splatting`` at
   1200x680 on 10 synthetic frames with ``configs/replica/
   gaussian_splatting.py`` as it is, cut to 500 iterations with the
   densification schedule scaled to match; PSNR must rise and end above
   20 dB, depth L1 below 5 cm; B3a-d launch once per iteration (B3a/B3b
   also per densification and evaluation render), B1/B2 never.
8. The refinement path: the SLAM map saved with ``save_params``, refined by
   ``splatam_torch.gs.post_opt.post_splatam_opt`` with ``configs/replica/
   post_splatam_opt.py`` cut to 300 iterations; its PSNR on those frames
   must stay within 0.5 dB of the loaded map's or rise.
9. The realtime path: ``splatam_torch.realtime.realtime_slam`` on the
   synthetic sequence at 1200x680 with ``configs/replica/splatam.py``
   (tracking 40 / mapping 60 iterations, window 24, keyframe every 5) cut
   to 20 frames, the realtime CLI's gain defaults (k_sil 1000, k_eig 0.1,
   k_sum 1, 40 Monte-Carlo poses), and gain requests of 8 candidate poses
   before frames 5, 10 and 15. Gains must be finite with EIG > 0, the pose
   2.5 m back must see more unmapped space than the current view, ATE
   < 0.03 m, and every call site's launches must be exact: B3a-d for
   tracking, densification and mapping (the config's split layout), B1
   for the dataset's renders, B1 + B4 per H_train pose and per candidate.
   Then ``fisher_gains_batch`` on the final map and 8 candidates through
   the kernels and through their plain versions on the card: the largest
   relative difference of the silhouette gain and of EIG is printed, and
   the candidates' order by gain must not change.
10. ``[slam_cli]``: the SLAM CLI (``splatam_torch.run.slam.main``) on
   sequences written to disk from the synthetic scene: a ``[data]`` line
   first (which of imageio, PIL, cv2 and yaml import, whether the native
   decoder builds, the decoder the loaders use); then Replica's format
   (JPEG color, 16-bit PNG depth at 6553.5, traj.txt) at 1200x680 with
   ``configs/replica/splatam.py`` and ``splatam_s.py`` (its 600x340
   densification and fixed binning), and TUM's (PNG color, depth at 5000,
   rgb/depth/groundtruth lists, crop_edge 8) at 640x480 with
   ``configs/tum/splatam.py`` (its depth-loss threshold), each as shipped
   but for the printed cuts (the data paths, the workdir, 8 frames); the
   files are written with Pillow, and the phase fails where neither
   imageio nor Pillow imports. Each run's params.npz, splat.ply and eval/psnr.txt must
   exist, ATE and PSNR be finite, its launches match its renders and the
   evaluation's its frames. The Replica run saves a checkpoint at frame 4
   and one more run resumes from it.
11. ``[clis]``: the other CLIs' ``main`` on ``[slam_cli]``'s Replica
   sequence and map, each config as shipped but for the printed cuts,
   each with exact launch counts (first a line of whether matplotlib,
   open3d and wandb import; wandb, where present, runs disabled):
   ``run.gaussian_splatting`` (``configs/replica/gaussian_splatting.py``,
   8 frames, 200 iterations, densification scaled as ``[offline]``'s),
   ``run.post_opt`` (``configs/replica/post_splatam_opt.py`` from the
   Replica run's params.npz, 100 iterations, stride 1: stride 20 keeps 1
   of 8 frames; PSNR within 0.5 dB of the loaded map's, or above),
   ``run.export_ply`` (its PLY reads back to the SLAM CLI's splat.ply
   arrays), ``run.viz --every 4`` (the recon PNGs at the config's size,
   trajectory.png where matplotlib imports), ``run.eval_novel_view`` on
   the train split (rendered_rgb/ written, with imageio or Pillow) and on
   a Replica-V2 test split written from the synthetic scene (4 poses
   between the train poses; ``configs/replica_v2/eval_novel_view.py``
   pointed at the Replica run; NVS PSNR finite, the nvs_*.txt written);
   then ``run.slam`` with ``configs/replica/splatam.py`` for 4 frames with
   ``mean_sq_dist_method="knn"`` (its time at frame 0 printed),
   ``mapping.do_ba`` at the tracking lrs, Inria densification in mapping
   (``densify_dict`` scaled to the 60 mapping iterations), wandb and,
   where matplotlib imports, the tracking-loss figures: ATE finite, the
   map densified at least once, a keyframe pose moved by BA, one figure
   per binning segment.
12. ``[parallel]``: the multi-device modules (``splatam_torch/parallel/``)
   on ``bench.py``'s 200k scene at 1200x680: ``band_partition`` into 4 row
   bands and ``grid_partition`` into 4 cells from the scene's binning
   counts, each band and cell rendered by the per-band body one after
   another, in both layouts, and assembled, against the unsharded render
   (color and final T atol 1e-5, median depth moved by > 1e-4 on under
   0.1% of pixels, gradients of a fixed cotangent within 2e-5 of scale),
   each band's instances and forward + backward ms (CUDA events); the 4
   shards of ``render_prim_sharded`` in this process against the unsharded
   fused render, each shard's gradients against its slice; then a process
   group of world size 1 (NCCL, a file store under build/) through the
   real wrappers: ``rasterize_rows_sharded`` and ``render_prim_sharded``
   against the unsharded renders, and ``batched_map_step`` over 4 keyframes
   of the [slam] map (shard_axis "tiles"): its loss the keyframes' mean,
   its Adam moments those of the mean gradient, its ms per keyframe; then
   a gloo process group of 4 ranks sharing the card (4 processes on
   cuda:0, a file store under build/): ``rasterize_rows_sharded`` over the
   row bands and the grid, ``render_prim_sharded`` over 4 shards and
   ``batched_map_step`` over a 2x2 (data, tiles) mesh, each rank held to
   the same computation in its own process, with its own exact launches; a
   degree-3 SH render (16 coefficients) through the kernels against the
   plain versions, with its gradients in the coefficients and the means;
   the dense oracle (``render/reference.py``) against B1's forward and
   B2's gradients on the three golden scenes, and against tests/goldens.
   Every time beside the card's name and power limit; exact launches.

The last lines are a JSON line of per-kernel numbers (all eleven kernels;
P1's also carries its per-stage ms) and ``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of the
repository, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py [--frames N]  (SLAM frames, default 60)
"""
from __future__ import annotations

import argparse
import contextlib
import copy
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
# B1, B2, B3a-d and B4 are also held to their plain versions at these
# staged batches (512 = MAX_CHUNK: past 48 KB of shared memory, the opt-in's
# launch)
CHUNKS = (256, 512)
# H100 SXM published peaks (NVIDIA's data sheet, at the 700 W limit): f32
# outside the tensor cores, and HBM bandwidth
F32_PEAK_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# and for the probes' bounds: bf16 outside the tensor cores (packed pairs,
# twice the f32 rate; the Hopper architecture white paper), the dense bf16
# tensor-core rate (data sheet), and the special-function unit (exp2, log2,
# ...): 16 results per clock per SM (CUDA C++ Programming Guide, throughput
# table, compute capability 9.0) x 132 SMs x the 1.98 GHz boost clock
BF16X2_PEAK_FLOPS = 133.8e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12  # the dense TF32 tensor-core rate (data sheet)
SFU_OPS_S = 16 * 132 * 1.98e9
MAP_FEATS = 6  # the mapping loss's fused channels: RGB, depth, silhouette, depth^2
# f32 operations per (pixel, instance) pair that the kernels' function
# needs (exp counted as one): alpha 16, transmittance test and weight 4,
# median-depth crossing 2, then 2 per feature channel for the blend. The
# backward replays alpha and the test (19), then gc (2 per channel), the
# suffix, dalpha, d/dopacity and dpower (12), the five geometry rows (16),
# the crossing (2), the feature rows (1 per channel) and the per-pixel sum
# of each gradient row (7 + 1 per channel).
FWD_OPS = (22, 2)  # (constant, per feature channel)
BWD_OPS = (56, 4)
# B4's function at its least, in its moment form (the rows are op^2 times
# fixed combinations of the pixel moments of dop^2, so the per-pair rows,
# products and their sums are not needed): per evaluated pair the replay
# (19), the suffix, dalpha and d/dopacity (11) and its square (1) in f32,
# and the 15 moments' multiply-adds (30 flops) on the tensor cores at the
# TF32 rate; per instance gc over the 3 seeded channels (6). The per
# instance recombination of the rows is not counted.
FISHER_OPS = 19 + 11 + 1
FISHER_TC_FLOPS = 2 * 15
FISHER_INSTANCE_OPS = 6
FISHER_SEED = 1e-3  # on RGB (fisher.py:148 of the JAX package)
FISHER_TOL = 1e-4  # per moment column, of its largest magnitude


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


# screen means of far_contention's large gaussians: 100-600 px outside the
# 64 x 48 image, which each still covers
FAR_UV = np.array([[-100, 10], [-250, 40], [-400, 20], [-600, 30], [214, 5],
                   [414, 45], [20, -120], [50, -300], [10, 248], [40, 548]],
                  np.float64)


def small_scene(kind, seed=3):
    """The saturating and empty scenes of tests/test_torch_raster.py, the
    interior-only scene of tests/test_pallas.py, and far_contention and
    threshold (which that raster test takes from here). far_contention
    stresses the backward's moment form: FAR_UV's gaussians in front (their
    tile sums recombine from far off-tile means), one in front of them all
    covering every tile (every block adds to its row), and a stack of
    opaque 3-8 px gaussians that saturates the two top-left tiles.
    threshold holds alpha's 1/255 floor: 24 faint gaussians 40-80 px wide
    over otherwise empty tiles (376 more lie behind the camera), their
    opacities 0.99-1.03 x 1/255, so that
    op exp(power) lies within 2% of 1/255 at ~12,000 (pixel, gaussian)
    pairs over 97% of the pixels, ~650 of them within 1e-3 in power; T
    stays above 0.98, and one pair wrongly kept or dropped moves its
    pixel's final T by 0.4%."""
    rng = np.random.default_rng(seed)
    if kind == "threshold":
        n, w, h, k = 400, 64, 48, 24  # the k faint gaussians in front
        f, cx, cy = w * 1.2, w / 2, h / 2
        z = rng.uniform(1.0, 3.0, n)
        z[k:] = -z[k:]  # the rest behind the camera
        uv = rng.uniform([-8.0, -6.0], [w + 8.0, h + 6.0], (n, 2))
        means = np.stack([(uv[:, 0] - cx) * z / f, (uv[:, 1] - cy) * z / f,
                          z], -1)
        scales = np.repeat((rng.uniform(40, 80, n) * np.abs(z) / f)[:, None],
                           3, 1)
        opac = rng.uniform(0.99, 1.03, n) / 255
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
    elif kind == "far_contention":
        n, w, h = 400, 64, 48
        f, cx, cy = w * 1.2, w / 2, h / 2
        z = rng.uniform(0.5, 6.0, n)
        means = np.stack([(rng.uniform(0, 32, n) - cx) * z / f,
                          (rng.uniform(0, 16, n) - cy) * z / f, z], -1)
        scales = np.repeat((rng.uniform(3, 8, n) * z / f)[:, None], 3, 1)
        opac = np.full(n, 0.95)
        k = len(FAR_UV)
        out = np.maximum(np.maximum(-FAR_UV[:, 0], FAR_UV[:, 0] - w),
                         np.maximum(-FAR_UV[:, 1], FAR_UV[:, 1] - h))
        zf = rng.uniform(1.0, 1.3, k)
        means[:k] = np.stack([(FAR_UV[:, 0] - cx) * zf / f,
                              (FAR_UV[:, 1] - cy) * zf / f, zf], -1)
        scales[:k] = ((0.45 * out + 20) * zf / f)[:, None]
        opac[:k] = rng.uniform(0.3, 0.5, k)
        means[k], scales[k], opac[k] = [0.0, 0.0, 0.45], 40 * 0.45 / f, 0.3
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
    elif kind == "saturating":
        n, w, h = 400, 64, 48
        means = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.7, 0.7, n),
                          rng.uniform(0.5, 6.0, n)], -1)
        opac = np.full(n, 0.95)
        scales = np.full((n, 3), 0.25)
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
    elif kind == "interior_only":  # tests/test_pallas.py: one tile holds
        # exactly one whole chunk of tiny gaussians (residue 0)
        rng = np.random.default_rng(3)
        n, w, h = 128, 64, 48
        means = np.tile([[0.02, 0.02, 2.0]], (n, 1))
        means[:, 2] += rng.uniform(0, 0.5, n)
        feats = rng.uniform(0, 1, (n, 3))
        opac = np.full(n, 0.4)
        scales = np.full((n, 3), 0.002)
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
        k = [[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]]
        f32 = [np.asarray(x, np.float32)
               for x in (means, feats, opac, scales, quats)]
        return (*f32, w, h, k)
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


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps, warmup=1):
    """Mean ms of ``fn()`` on the card (CUDA events after ``warmup``)."""
    import torch

    from splatam_torch.bench.timing import time_ms

    return time_ms(fn, reps, torch.device("cuda", torch.cuda.current_device()),
                   warmup)


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "unknown (no nvidia-smi)"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def synchronize(dev):
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    try:  # the toolchain record only: no kernel of the port is Triton's
        import triton

        log(f"[build] triton {triton.__version__} imports")
    except Exception as e:  # noqa: BLE001
        log(f"[build] triton does not import: {e!r}")
    check_sass()


# Tensor-core products each kernel must keep in its SASS, per (source, a
# substring of the mangled function name): P3's pass is 144 mma.sync per
# 16-row band (36 non-zero 16 x 16 blocks of U x 2 n-tiles x 2 terms), dual
# two passes; P4's mxu 72 per 16-row tile, the two-product bodies (mxu2dep,
# mxu2ind) 144; B2's, B3c's and B3d's warp sums 20 per sub-batch (4
# k-steps x 2 moment and 3 feature passes), as P1's from `moments` on;
# B4's 24 (4 k-steps x 2 n-tiles of moments x 3 passes).
MIN_HMMA = {
    ("probe_ilp", "kernelILi1E"): 144, ("probe_ilp", "kernelILi2E"): 144,
    ("probe_ilp", "kernelILi3E"): 288,
    ("probe_step", "kernelILi2E"): 72, ("probe_step", "kernelILi3E"): 144,
    ("probe_step", "kernelILi4E"): 144,
    ("raster_bwd", "raster_bwd_kernel"): 20,
    ("raster_split_bwd", "split_int_bwd_kernel"): 20,
    ("raster_split_bwd", "split_tail_bwd_kernel"): 20,
    ("raster_fisher", "raster_fisher_kernel"): 24,
    ("probe_ablate", "kernelILi7E"): 20, ("probe_ablate", "kernelILi8E"): 20,
    ("probe_ablate", "kernelILi9E"): 20,
}


def check_sass():
    """Count the mma instructions (HMMA) ptxas kept in each tensor-core
    kernel: it may merge products it can prove equal, and then a kernel
    would do, or a probe time, less work than it reports."""
    import shutil

    from splatam_torch.render import raster

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for src in sorted({name for name, _ in MIN_HMMA}):
        sass = subprocess.run([tool, "-sass", str(raster._library_path(src))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
        for (name, tag), least in MIN_HMMA.items():
            if name != src:
                continue
            got = [c for f, c in counts.items() if tag in f]
            if len(got) != 1 or got[0] < least:
                fail(f"{src} {tag}: {got} mma instructions in its SASS, "
                     f"expected at least {least}")
            log(f"[build] {src} {tag}: {got[0]} mma instructions "
                f"(at least {least})")
    log(f"card: {nvidia_smi_line()}")


class Setup:
    """One view's kernel inputs: the attribute table and its binning."""

    def __init__(self, attrs, binned, grid_x, nfeat, chunk=CHUNK):
        self.attrs, self.binned, self.grid_x, self.nfeat, self.chunk = (
            attrs, binned, grid_x, nfeat, chunk)

    @property
    def args(self):
        return (self.attrs, self.binned.sorted_gid, self.binned.ranges,
                self.grid_x, self.chunk)


def scene_setup(scene, dev, mapping_feats=False, layout="aligned",
                chunk=CHUNK):
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
    binned = bin_gaussians_csr(proj, cam,
                               RasterConfig(chunk=chunk, layout=layout),
                               opacities=t["opac"])
    attrs = pack_attrs(proj.means2d, proj.conic, t["opac"], proj.depths,
                       t["feats"])
    return Setup(attrs, binned, grid_dims(cam)[0], t["feats"].shape[1], chunk)


def compare_kernels(name, s: Setup, rng, errs):
    """B1 and B2 against their plain versions, in the full setting and in
    the mapping loss's narrowed one (4 gradient channels, no median depth)."""
    import torch

    from splatam_torch.render import raster

    out = {}
    for carry, nfeat in ((True, s.nfeat), (False, min(s.nfeat, 4))):
        tag = f"{name} carry_depth={carry}"
        c1, a1 = raster.raster_fwd_cuda(*s.args, carry)
        torch.cuda.synchronize()
        c0, a0, evaluated = raster.raster_fwd_plain(*s.args, carry)
        e_fwd = max(check_close(f"B1 {tag} color", c1, c0, FWD_ATOL),
                    check_close(f"B1 {tag} median depth", a1[:, 0], a0[:, 0],
                                FWD_ATOL),
                    check_close(f"B1 {tag} final T", a1[:, 1], a0[:, 1],
                                FINAL_T_ATOL))
        check_equal(f"B1 {tag} saturation depth", a1[:, 2:], a0[:, 2:])

        g_color, g_aux = cotangents(c0, a0, nfeat, carry, rng)
        g1 = raster.raster_bwd_cuda(*s.args, c1, a1, g_color, g_aux, nfeat, carry)
        torch.cuda.synchronize()
        g0 = raster.raster_bwd_plain(*s.args, c0, a0, g_color, g_aux, nfeat, carry)
        e_bwd, scale = check_grad(f"B2 {tag}", g1, g0)
        errs["B1"] = max(errs["B1"], e_fwd)
        errs["B2"] = max(errs["B2"], e_bwd)
        saturated = int((a0[:, 2, 0] < raster.SAT_INF).sum())
        log(f"[kernels] {name:12s} carry_depth={carry!s:5s} nfeat={nfeat} "
            f"K={s.binned.num_instances} saturated_tiles={saturated} "
            f"B1_err={e_fwd:.3g} B2_err={e_bwd:.3g} B2_err/scale="
            f"{e_bwd / max(scale, 1e-30):.3g}")
        out[carry] = (c0, a0, evaluated)
    return out


def max_err(got, ref):
    return (got - ref).abs().max().item() if ref.numel() else 0.0


def check_close(label, got, ref, atol, rtol=FWD_RTOL):
    import torch

    if got.shape != ref.shape or not torch.allclose(got, ref, atol=atol,
                                                    rtol=rtol):
        fail(f"{label}: max err {max_err(got, ref):.3g}")
    return max_err(got, ref)


def check_equal(label, got, ref):
    import torch

    if not torch.equal(got, ref):
        fail(f"{label}: differs (max err {max_err(got, ref):.3g})")


def check_scaled(label, got, ref, rel):
    """Max abs error within ``rel`` of the reference's largest magnitude."""
    scale = ref.abs().max().item() if ref.numel() else 0.0
    err = max_err(got, ref)
    if got.shape != ref.shape or (err > rel * max(scale, 1e-30) and err > 0):
        fail(f"{label}: max err {err:.3g} against scale {scale:.3g}")
    return err, scale


def check_grad(label, got, ref):
    """Max abs error within GRAD_TOL of the reference's largest magnitude."""
    return check_scaled(label, got, ref, GRAD_TOL)


def cotangents(color, aux, nfeat, carry, rng):
    """Random dL/dcolor on the first ``nfeat`` channels and dL/d(median
    depth, final T); none on median depth when ``carry`` is off."""
    import torch

    g_color = torch.tensor(rng.normal(size=color.shape).astype(np.float32),
                           device=color.device)
    g_color[:, nfeat:] = 0.0
    g_aux = torch.tensor(rng.normal(size=aux.shape).astype(np.float32),
                         device=aux.device)
    g_aux[:, 2:] = 0.0
    if not carry:
        g_aux[:, 0] = 0.0
    return g_color, g_aux


def fisher_seed(dev):
    import torch

    seed = torch.zeros(8, dtype=torch.float32, device=dev)
    seed[:3] = FISHER_SEED
    return seed


def compare_fisher(name, s: Setup, color, errs):
    """B4 against its plain version on the aligned binning and the plain
    forward's color blocks: every moment column within FISHER_TOL of that
    column's largest magnitude (the moments are products of ~1e-3
    gradients; atomics sum them in an order that varies run to run)."""
    import torch

    from splatam_torch.render import raster

    seed = fisher_seed(color.device)
    m1 = raster.fisher_moments_cuda(*s.args, color, seed)
    torch.cuda.synchronize()
    m0 = raster.fisher_moments_plain(*s.args, color, seed)
    scale = m0.abs().amax(dim=0)
    err = (m1 - m0).abs().amax(dim=0)
    rel = err / scale.clamp_min(1e-30)
    bad = (err > FISHER_TOL * scale) & (err > 0)
    if m1.shape != m0.shape or bool(bad.any()):
        fail(f"B4 {name}: per-column err/scale {rel.tolist()}")
    errs["B4"] = max(errs["B4"], float(err.max()))
    log(f"[fisher] {name:21s} K={s.binned.num_instances} B4 max abs err "
        f"{float(err.max()):.3g}, worst column err/scale {float(rel.max()):.3g} "
        f"(limit {FISHER_TOL:g}); column scales "
        + " ".join(f"{v:.2g}" for v in scale.tolist()))


def check_render_fisher(name, scene, dev):
    """``render_fisher`` on the card (B1 + B4) against the plain path on
    the CPU, from the same raw parameters."""
    import torch

    from splatam_torch.fisher import render_fisher
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.render.camera import setup_camera

    means, feats, opac, scales, quats, w, h, k = scene
    raw = {
        "means3D": means, "rgb_colors": feats[:, :3], "unnorm_rotations": quats,
        "logit_opacities": np.log(opac / (1 - opac)).reshape(-1, 1),
        "log_scales": np.log(scales),
    }
    def fisher_on(d):
        params = {key: torch.as_tensor(np.asarray(v, np.float32), device=d)
                  for key, v in raw.items()}
        cam = setup_camera(w, h, k, np.eye(4), device=d)
        return render_fisher(
            params, None, torch.tensor([1.0, 0, 0, 0], device=d),
            torch.zeros(3, device=d), cam, RasterConfig(chunk=CHUNK),
            seed_value=FISHER_SEED).cpu()

    card, plain = fisher_on(dev), fisher_on(torch.device("cpu"))
    scale = float(plain.abs().max())
    err = float((card - plain).abs().max())
    if not (scale > 0 and err <= FISHER_TOL * scale):
        fail(f"render_fisher {name}: card vs CPU err {err:.3g}, scale {scale:.3g}")
    log(f"[fisher] render_fisher {name}: card vs CPU max err {err:.3g} "
        f"against scale {scale:.3g} (limit {FISHER_TOL:g} of scale)")


def check_split_fwd(tag, sp: Setup, carry):
    """B3a against its plain version; then B3b in place on clones of the
    plain B3a's outputs, from the plain carry, against ``compose_split`` of
    the plain B3a's and B3b's outputs. Returns (B3a's error, B3b's error,
    the plain outputs: c0, a0, k0, ev_i of B3a, cp0, ap0, ev_t of B3b, and
    the composed color and aux)."""
    import torch

    from splatam_torch.render import raster

    b, gx, chunk = sp.binned, sp.grid_x, sp.chunk
    c1, a1, k1 = raster.raster_split_int_fwd_cuda(sp.attrs, b, gx, chunk,
                                                  carry)
    torch.cuda.synchronize()
    c0, a0, k0, ev_i = raster.raster_split_int_fwd_plain(sp.attrs, b, gx,
                                                         chunk, carry)
    e3a = max(check_close(f"B3a {tag} color", c1, c0, FWD_ATOL),
              check_close(f"B3a {tag} median depth", a1[:, 0], a0[:, 0],
                          FWD_ATOL),
              check_close(f"B3a {tag} T", a1[:, 1], a0[:, 1], FINAL_T_ATOL),
              check_close(f"B3a {tag} carry T, depth", k1[:, :2], k0[:, :2],
                          FINAL_T_ATOL))
    check_equal(f"B3a {tag} saturation depth", a1[:, 2:], a0[:, 2:])
    check_equal(f"B3a {tag} carry death", k1[:, 0] < 0, k0[:, 0] < 0)
    check_equal(f"B3a {tag} carry candidate", k1[:, 2], k0[:, 2])

    cs1, as1 = raster.raster_split_tail_fwd_cuda(sp.attrs, b, k0, gx, chunk,
                                                 c0.clone(), a0.clone(), carry)
    torch.cuda.synchronize()
    cp0, ap0, ev_t = raster.raster_split_tail_fwd_plain(sp.attrs, b, k0, gx,
                                                        chunk, carry)
    color, aux = raster.compose_split(b, c0, a0, cp0, ap0)
    e3b = max(check_close(f"B3b {tag} color", cs1, color, FWD_ATOL),
              check_close(f"B3b {tag} median depth", as1[:, 0], aux[:, 0],
                          FWD_ATOL),
              check_close(f"B3b {tag} T", as1[:, 1], aux[:, 1], FINAL_T_ATOL))
    check_equal(f"B3b {tag} saturation depth", as1[:, 2:], aux[:, 2:])
    return e3a, e3b, dict(c0=c0, a0=a0, k0=k0, ev_i=ev_i, cp0=cp0, ap0=ap0,
                          ev_t=ev_t, color=color, aux=aux)


def compare_split_kernels(name, sp: Setup, al: Setup, rng, errs):
    """B3a-d each against its plain version, fed the plain version's inputs
    (carries included; B3b the plain B3a's outputs, which it finishes in
    place); then the split render and its gradients (kernels all the way)
    against B1/B2 on the same scene."""
    import torch

    from splatam_torch.render import raster

    b, gx, chunk = sp.binned, sp.grid_x, sp.chunk
    out = {}
    for carry, nfeat in ((True, sp.nfeat), (False, min(sp.nfeat, 4))):
        tag = f"{name} carry_depth={carry}"
        e3a, e3b, plain = check_split_fwd(tag, sp, carry)
        color, aux = plain["color"], plain["aux"]
        g_color, g_aux = cotangents(color, aux, nfeat, carry, rng)
        bwd_args = (gx, chunk, color, aux, g_color, g_aux, nfeat, carry)
        g1, bc1 = raster.raster_split_int_bwd_cuda(sp.attrs, b, *bwd_args)
        torch.cuda.synchronize()
        g0, bc0 = raster.raster_split_int_bwd_plain(sp.attrs, b, *bwd_args)
        e3c, s3c = check_grad(f"B3c {tag}", g1, g0)
        check_close(f"B3c {tag} carry T", bc1[:, 0], bc0[:, 0], FINAL_T_ATOL)
        check_grad(f"B3c {tag} carry prefix", bc1[:, 1], bc0[:, 1])
        check_equal(f"B3c {tag} carry death", bc1[:, 0] < 0, bc0[:, 0] < 0)
        gt1 = raster.raster_split_tail_bwd_cuda(sp.attrs, b, bc0, *bwd_args)
        torch.cuda.synchronize()
        gt0 = raster.raster_split_tail_bwd_plain(sp.attrs, b, bc0, *bwd_args)
        e3d, s3d = check_grad(f"B3d {tag}", gt1, gt0)

        # the split path on the card against the aligned kernels
        ca, aa = raster.raster_fwd_cuda(*al.args, carry)
        cs, as_, _ = raster.raster_split_fwd_cuda(sp.attrs, b, gx, chunk,
                                                  carry)
        e_sa = max(check_close(f"split vs aligned {tag} color", cs, ca,
                               FWD_ATOL),
                   check_close(f"split vs aligned {tag} median depth",
                               as_[:, 0], aa[:, 0], FWD_ATOL),
                   check_close(f"split vs aligned {tag} T", as_[:, 1],
                               aa[:, 1], 1e-6, 0.0))
        check_equal(f"split vs aligned {tag} saturation depth", as_[:, 2:],
                    aa[:, 2:])
        ga = raster.raster_bwd_cuda(*al.args, ca, aa, g_color, g_aux, nfeat,
                                    carry)
        sargs = (gx, chunk, cs, as_, g_color, g_aux, nfeat, carry)
        gs, bcs = raster.raster_split_int_bwd_cuda(sp.attrs, b, *sargs)
        gs = raster.raster_split_tail_bwd_cuda(sp.attrs, b, bcs, *sargs,
                                               grad=gs)
        torch.cuda.synchronize()
        e_gsa, s_gsa = check_grad(f"split vs aligned {tag} gradients", gs, ga)
        for k, e in (("B3a", e3a), ("B3b", e3b), ("B3c", e3c), ("B3d", e3d)):
            errs[k] = max(errs[k], e)
        log(f"[split] {name:12s} carry_depth={carry!s:5s} nfeat={nfeat} "
            f"NCi={b.chunk_meta.shape[0]} NCt={b.tmeta.shape[0]} "
            f"B3a={e3a:.3g} B3b={e3b:.3g} B3c={e3c:.3g}/{s3c:.3g} "
            f"B3d={e3d:.3g}/{s3d:.3g}; vs aligned fwd {e_sa:.3g} grad "
            f"{e_gsa:.3g}/{s_gsa:.3g}")
        out[carry] = plain
    return out


def compare_chunks(name, scene, dev, rng, errs, mapping_feats=False,
                   fisher=True):
    """B1, B2 and B3a-d against their plain versions at the staged batches
    of CHUNKS (the split binned at each), in the full and the narrowed
    setting. B1 gets the plain forward's checks, B3a and B3b those of
    ``check_split_fwd``; B2 and B3c the same forward outputs and cotangents
    as their plain versions; B3d the plain B3c carry. With ``fisher``, B4
    too (``compare_fisher``, on the plain forward's color blocks)."""
    import torch

    from splatam_torch.render import raster

    for chunk in CHUNKS:
        al = scene_setup(scene, dev, mapping_feats, chunk=chunk)
        sp = scene_setup(scene, dev, mapping_feats, "split", chunk)
        b, gx = sp.binned, sp.grid_x
        for carry, nfeat in ((True, al.nfeat), (False, min(al.nfeat, 4))):
            tag = f"{name} chunk={chunk} carry_depth={carry}"
            c, a = raster.raster_fwd_cuda(*al.args, carry)
            torch.cuda.synchronize()
            c0, a0, _ = raster.raster_fwd_plain(*al.args, carry)
            e1 = max(check_close(f"B1 {tag} color", c, c0, FWD_ATOL),
                     check_close(f"B1 {tag} median depth", a[:, 0], a0[:, 0],
                                 FWD_ATOL),
                     check_close(f"B1 {tag} final T", a[:, 1], a0[:, 1],
                                 FINAL_T_ATOL))
            check_equal(f"B1 {tag} saturation depth", a[:, 2:], a0[:, 2:])
            if fisher and carry:
                compare_fisher(f"{name} chunk={chunk}", al, c0, errs)
            g_color, g_aux = cotangents(c, a, nfeat, carry, rng)
            g1 = raster.raster_bwd_cuda(*al.args, c, a, g_color, g_aux, nfeat,
                                        carry)
            torch.cuda.synchronize()
            g0 = raster.raster_bwd_plain(*al.args, c, a, g_color, g_aux, nfeat,
                                         carry)
            e2, s2 = check_grad(f"B2 {tag}", g1, g0)
            e3a, e3b, plain = check_split_fwd(tag, sp, carry)
            color, aux = plain["color"], plain["aux"]
            bargs = (gx, chunk, color, aux, g_color, g_aux, nfeat, carry)
            g1, bc1 = raster.raster_split_int_bwd_cuda(sp.attrs, b, *bargs)
            torch.cuda.synchronize()
            g0, bc0 = raster.raster_split_int_bwd_plain(sp.attrs, b, *bargs)
            e3, s3 = check_grad(f"B3c {tag}", g1, g0)
            check_close(f"B3c {tag} carry T", bc1[:, 0], bc0[:, 0],
                        FINAL_T_ATOL)
            check_grad(f"B3c {tag} carry prefix", bc1[:, 1], bc0[:, 1])
            check_equal(f"B3c {tag} carry death", bc1[:, 0] < 0, bc0[:, 0] < 0)
            gt1 = raster.raster_split_tail_bwd_cuda(sp.attrs, b, bc0, *bargs)
            torch.cuda.synchronize()
            gt0 = raster.raster_split_tail_bwd_plain(sp.attrs, b, bc0, *bargs)
            e4, s4 = check_grad(f"B3d {tag}", gt1, gt0)
            for kname, e in (("B1", e1), ("B2", e2), ("B3a", e3a),
                             ("B3b", e3b), ("B3c", e3), ("B3d", e4)):
                errs[kname] = max(errs[kname], e)
            log(f"[kernels] {name:12s} chunk={chunk} carry_depth={carry!s:5s} "
                f"nfeat={nfeat} B1 {e1:.3g} B2 {e2:.3g}/{s2:.3g} B3a "
                f"{e3a:.3g} B3b {e3b:.3g} B3c {e3:.3g}/{s3:.3g} B3d "
                f"{e4:.3g}/{s4:.3g} (NCt={b.tmeta.shape[0]}; err/scale, "
                f"limit {GRAD_TOL:g})")
        del al, sp, b, plain
        torch.cuda.empty_cache()


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
    errs = {k: 0.0 for k in KERNEL_NAMES}
    for name, scene in golden_scenes().items():
        check_goldens(name, scene, dev)
        al = scene_setup(scene, dev)
        outs = compare_kernels(name, al, rng, errs)
        compare_fisher(name, al, outs[True][0], errs)
        compare_split_kernels(name, scene_setup(scene, dev, layout="split"),
                              al, rng, errs)
        compare_chunks(name, scene, dev, rng, errs)
    log("[kernels] golden renders match tests/goldens")
    check_render_fisher("dense_aniso", golden_scenes()["dense_aniso"], dev)
    for kind in ("saturating", "empty", "interior_only", "far_contention",
                 "threshold"):
        al = scene_setup(small_scene(kind), dev)
        outs = compare_kernels(kind, al, rng, errs)
        if kind != "interior_only":
            compare_fisher(kind, al, outs[True][0], errs)
        compare_split_kernels(kind, scene_setup(small_scene(kind), dev,
                                                layout="split"),
                              al, rng, errs)
        compare_chunks(kind, small_scene(kind), dev, rng, errs,
                       fisher=kind != "interior_only")
    # the 200k scene as the mapping loss renders it: isotropic scales,
    # sigmoid opacities, 6 fused channels
    from splatam_torch.bench.scene import make_scene

    p, w, h, k = make_scene(*bench_size)
    scene = (
        p["means3D"], p["rgb_colors"],
        (1 / (1 + np.exp(-p["logit_opacities"][:, 0]))).astype(np.float32),
        np.tile(np.exp(p["log_scales"]), (1, 3)), p["unnorm_rotations"],
        w, h, k,
    )
    bench = scene_setup(scene, dev, mapping_feats=True)
    outs = compare_kernels("bench_200k", bench, rng, errs)
    compare_fisher("bench_200k", bench, outs[True][0], errs)
    bench_split = scene_setup(scene, dev, mapping_feats=True, layout="split")
    outs_split = compare_split_kernels("bench_200k", bench_split, bench, rng,
                                       errs)
    compare_chunks("bench_200k", scene, dev, rng, errs, mapping_feats=True)
    return errs, (bench, outs), (bench_split, outs_split)


def bound_ms(nbytes, ops, tc_flops=0.0, tc_peak=BF16_TC_FLOPS):
    """The least time on this card (ms) for moving ``nbytes``, doing ``ops``
    f32 operations and ``tc_flops`` on the tensor cores at ``tc_peak`` (the
    units overlapping perfectly), and which bounds it: bytes or
    operations."""
    tb = nbytes / HBM_BYTES_S
    to = max(ops / F32_PEAK_FLOPS, tc_flops / tc_peak)
    return max(tb, to) * 1e3, ("operations" if to >= tb else "bytes")


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
    return bound_ms(fwd_bytes, fwd_ops), bound_ms(bwd_bytes, bwd_ops), pairs


def fisher_bound(s: Setup, evaluated):
    """B4's least time in ms on this card for this run's inputs: the
    attribute table, stream, ranges, color blocks and seed read once, the
    (N, 16) moments written once; FISHER_OPS and FISHER_TC_FLOPS per
    evaluated pair, FISHER_INSTANCE_OPS per instance."""
    n, t, k = s.attrs.shape[0], s.binned.ranges.shape[0], s.binned.num_instances
    nbytes = n * 16 * 4 + k * 4 + t * 2 * 4 + t * 8 * 256 * 4 + 8 * 4 + n * 16 * 4
    pairs = int(evaluated.sum())
    return bound_ms(nbytes, pairs * FISHER_OPS + k * FISHER_INSTANCE_OPS,
                    pairs * FISHER_TC_FLOPS, TF32_TC_FLOPS)


def split_bounds(s: Setup, ev_i, ev_t, nfeat_bwd):
    """B3a-d least times in ms on this card for this run's inputs: each
    kernel's own stream region, tables, carries and the blocks of the
    tiles it owns, read once, and its outputs written once."""
    b = s.binned
    n, t = s.attrs.shape[0], b.int_ranges.shape[0]
    nci, nct = b.chunk_meta.shape[0], b.tmeta.shape[0]
    tail = b.mask_a | b.mask_b
    carried = int((tail & b.mask_int).sum())  # tail tiles that read a carry
    row = 256 * 4  # one f32 row of a tile
    block = 8 * row  # one (8, 256) f32 tile block
    attrs = n * 16 * 4  # the attribute table in, or the gradient table out
    gid_i, gid_t = nci * CHUNK * 4, nct * CHUNK * 4
    ranges, tables = t * 2 * 4, 3 * nct * 4
    pairs_i, pairs_t = int(ev_i.sum()), int(ev_t.sum())
    fwd = FWD_OPS[0] + FWD_OPS[1] * s.nfeat
    bwd = BWD_OPS[0] + BWD_OPS[1] * nfeat_bwd
    return {
        # color and aux out, carry (3 rows) out
        "B3a": bound_ms(attrs + gid_i + ranges + t * (2 * block + 3 * row),
                        pairs_i * fwd),
        # carries in; the tail tiles' color in and out, aux rows 0-2 out
        "B3b": bound_ms(attrs + gid_t + tables + carried * 3 * row
                        + int(tail.sum()) * (2 * block + 3 * row),
                        pairs_t * fwd),
        # color, aux and both cotangents in, gradients and carry out
        "B3c": bound_ms(attrs + gid_i + ranges + t * (4 * block + 2 * row)
                        + attrs, pairs_i * bwd),
        # carries and the tail tiles' four blocks in, gradients out
        "B3d": bound_ms(attrs + gid_t + tables + carried * 2 * row
                        + int(tail.sum()) * 4 * block + attrs, pairs_t * bwd),
    }, pairs_i + pairs_t


def phase_timing(aligned, split, dev):
    """Every kernel's time on the 200k scene in the mapping loss's setting
    (4 gradient channels, no median depth)."""
    import torch

    from splatam_torch.render import raster

    bench, outs = aligned
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
    seed = fisher_seed(dev)
    fish = lambda: raster.fisher_moments_cuda(*bench.args, c0, seed)  # noqa: E731
    fish_plain = lambda: raster.fisher_moments_plain(  # noqa: E731
        *bench.args, c0, seed)
    times = {
        "B1": (cuda_ms(fwd, 20), cuda_ms(fwd_plain, 2, warmup=0)),
        "B2": (cuda_ms(bwd, 20), cuda_ms(bwd_plain, 2, warmup=0)),
        "B4": (cuda_ms(fish, 20), cuda_ms(fish_plain, 2, warmup=0)),
    }
    (b1, b1_by), (b2, b2_by), pairs = kernel_bounds(bench, evaluated, nfeat)
    bounds = {"B1": (b1, b1_by), "B2": (b2, b2_by),
              "B4": fisher_bound(bench, evaluated)}

    sp, souts = split
    o = souts[carry]
    sb, gx = sp.binned, sp.grid_x
    bargs = (gx, CHUNK, o["color"], o["aux"], g_color, g_aux, nfeat, carry)
    _, bcarry = raster.raster_split_int_bwd_cuda(sp.attrs, sb, *bargs)
    # B3b finishes B3a's outputs in place: its plain version is the plain
    # tail and compose_split (the color it adds into accumulates over the
    # timed calls; the work does not change)
    ci, ai = o["c0"].clone(), o["a0"].clone()
    runs = {
        "B3a": (lambda: raster.raster_split_int_fwd_cuda(
                    sp.attrs, sb, gx, CHUNK, carry),
                lambda: raster.raster_split_int_fwd_plain(
                    sp.attrs, sb, gx, CHUNK, carry)),
        "B3b": (lambda: raster.raster_split_tail_fwd_cuda(
                    sp.attrs, sb, o["k0"], gx, CHUNK, ci, ai, carry),
                lambda: raster.compose_split(
                    sb, o["c0"], o["a0"], *raster.raster_split_tail_fwd_plain(
                        sp.attrs, sb, o["k0"], gx, CHUNK, carry)[:2])),
        "B3c": (lambda: raster.raster_split_int_bwd_cuda(sp.attrs, sb, *bargs),
                lambda: raster.raster_split_int_bwd_plain(sp.attrs, sb, *bargs)),
        "B3d": (lambda: raster.raster_split_tail_bwd_cuda(
                    sp.attrs, sb, bcarry, *bargs),
                lambda: raster.raster_split_tail_bwd_plain(
                    sp.attrs, sb, bcarry, *bargs)),
    }
    for k, (kernel, plain) in runs.items():
        times[k] = (cuda_ms(kernel, 20), cuda_ms(plain, 2, warmup=0))
    # what B3b's in-place write took off the card's split forward: the
    # compose of per-chunk pair blocks into the tiles, a dozen tensor ops
    compose_ms = cuda_ms(lambda: raster.compose_split(
        sb, o["c0"], o["a0"], o["cp0"], o["ap0"]), 20)
    # one differentiable split forward (B3a, B3b, no compose) on the host's
    # clock between synchronisations: what the loops wait for
    attrs_g = sp.attrs.clone().requires_grad_(True)
    host = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raster.rasterize_tiles(attrs_g, sb, gx, CHUNK, nfeat, carry)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    split_host_ms = float(np.median(host[1:]))
    sbounds, spairs = split_bounds(sp, o["ev_i"], o["ev_t"], nfeat)
    bounds.update(sbounds)
    log(f"[timing] 200k scene: K={bench.binned.num_instances} instances; "
        f"aligned {pairs} (pixel, instance) pairs evaluated, split {spairs} "
        f"(NCi={sb.chunk_meta.shape[0]} interior, NCt={sb.tmeta.shape[0]} "
        f"tail chunks of {CHUNK})")
    regs, blocks = raster.FISHER_KERNEL.occupancy(CHUNK)
    for kname in times:
        ms, plain = times[kname]
        log(f"[timing] {kname}: {ms:.4f} ms kernel, {plain:.2f} ms plain, "
            f"bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]})"
            + (f"; {regs} registers, {blocks} blocks per SM" if kname == "B4"
               else ""))
    log(f"[timing] compose_split on the card (no longer on the CUDA path): "
        f"{compose_ms:.4f} ms; one split forward on the host's clock, "
        f"synced: {split_host_ms:.4f} ms (median of 20)")
    split_ms = sum(times[k][0] for k in ("B3a", "B3b", "B3c", "B3d"))
    log(f"[timing] split forward + backward {split_ms:.4f} ms against "
        f"aligned {times['B1'][0] + times['B2'][0]:.4f} ms")
    return times, bounds


def phase_iteration(dev, layout, iters=10, bench_size=(200_000, 1200, 680)):
    """One SLAM mapping iteration (render + loss + backward + Adam,
    ``map_step``) at chunk 128 on the 200k scene in the stream ``layout``,
    binning frozen for ``iters`` iterations and capped at the previous
    render's saturation depth. Not bench.py's program: that one is
    ``splatam_torch.bench`` (gradient only, chunk 256), in ``[bench]``."""
    import torch

    from splatam_torch.bench.profile import profile_block
    from splatam_torch.bench.scene import make_scene
    from splatam_torch.core.losses import compute_binned
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.slam.mapping import init_mapping_optimizer, map_step

    params_np, w, h, k = make_scene(*bench_size)
    params = {key: torch.as_tensor(v, device=dev) for key, v in params_np.items()}
    cam = setup_camera(w, h, k, np.eye(4), device=dev)
    cfg = RasterConfig(chunk=CHUNK, layout=layout)
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
        fail("map_step on the 200k scene gave a non-finite loss")
    mpix_s = w * h / (ms * 1e-3) / 1e6
    log(f"[map_step c{CHUNK}] {layout}: 200k gaussians at {w}x{h}: {ms:.3f} ms "
        f"per map_step (forward + backward + Adam, binning frozen for "
        f"{iters}), {mpix_s:.2f} Mpix/s")
    if dev.type == "cuda":
        profile_block(block, iters)
    return ms, mpix_s


KERNEL_NAMES = ("B1", "B2", "B3a", "B3b", "B3c", "B3d", "B4", "P1", "P2",
                "P3", "P4")


def reset_launches():
    from splatam_torch.render import raster

    for k in KERNEL_NAMES:
        raster.KERNELS[k].launches = 0


def read_launches():
    from splatam_torch.render import raster

    return {k: raster.KERNELS[k].launches for k in KERNEL_NAMES}


def expected_launches(layout, renders, iters):
    """Launches of ``renders`` renders (``iters`` of them differentiated)
    in the stream ``layout``."""
    fwd, bwd = (("B1",), ("B2",)) if layout == "aligned" else (
        ("B3a", "B3b"), ("B3c", "B3d"))
    out = {k: 0 for k in KERNEL_NAMES}
    for k in fwd:
        out[k] += renders
    for k in bwd:
        out[k] += iters
    return out


def check_launches(phase, launches, expect):
    log(f"[{phase}] launches {json.dumps(launches)}")
    if launches != expect:
        fail(f"{phase}: launch counts {launches} do not match the run: "
             f"expected {expect}")


def phase_slam(frames, device, width=1200, height=680, track=40, map_=60):
    """The SLAM path through the CLI's entry points, at Replica width,
    with Replica's iterations (tracking 40, mapping 60, window 24)."""
    from splatam_torch.run import synthetic_slam

    args = synthetic_slam.parse_args([
        "--width", str(width), "--height", str(height), "--frames",
        str(frames), "--track_iters", str(track), "--map_iters", str(map_),
        "--window", "24", "--device", str(device),
    ])
    reset_launches()
    result, state = synthetic_slam.run(args)
    launches = read_launches()
    log(f"[slam] {json.dumps(result)}")
    c = state.counts
    iters = c["tracking_iters"] + c["mapping_iters"]
    # every iteration renders once and backpropagates once, in the layout
    # frame 0 resolved; so does each densification check. The dataset's
    # ground-truth renders are aligned, the evaluation renders split.
    expect = expected_launches(state.layout, iters + c["densify_renders"],
                               iters)
    for k, v in expected_launches("aligned", frames, 0).items():
        expect[k] += v
    for k, v in expected_launches("split", frames, 0).items():
        expect[k] += v
    tm = state.timing
    log(f"[slam] layout {state.layout}; mean ms per iteration: tracking "
        f"{1e3 * np.mean(tm['tracking_iter']):.2f}, mapping "
        f"{1e3 * np.mean(tm['mapping_iter']):.2f}; last frame: tracking "
        f"{tm['tracking_frame'][-1]:.2f} s, mapping {tm['mapping_frame'][-1]:.2f} s")
    log(f"[slam] iterations tracking={c['tracking_iters']} "
        f"mapping={c['mapping_iters']}, densify renders="
        f"{c['densify_renders']}, frames={frames}")
    check_launches("slam", launches, expect)
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
    return result, launches, state


def load_config(name):
    from splatam_torch.run.common import load_experiment_config

    return load_experiment_config(os.path.join(ROOT, "configs", "replica", name))


def cut(config, path, value):
    """Set config[path...] = value and print the cut."""
    *head, last = path
    d = config
    for key in head:
        d = d[key]
    log(f"[cut] {'.'.join(path)}: {d.get(last)} -> {value}")
    d[last] = value


def frame_metrics(state, seq, frames, cfg, phase, tag):
    """Per-frame PSNR and depth L1 of ``state``'s map at its poses; prints
    them with the gaussian count. Returns the mean PSNR and depth L1."""
    from splatam_torch.core.params import num_gaussians
    from splatam_torch.run.synthetic_slam import evaluate

    psnr, depth_l1 = evaluate(state, seq, frames, cfg)
    log(f"[{phase}] {tag}: {num_gaussians(state.params)} gaussians; PSNR "
        + " ".join(f"{v:.2f}" for v in psnr) + " dB; depth L1 "
        + " ".join(f"{v:.4f}" for v in depth_l1) + " m")
    return float(np.mean(psnr)), float(np.mean(depth_l1))


def synthetic_frames(frames, dev, width=1200, height=680):
    """The synthetic sequence's frames, rendered (aligned, B1) up front."""
    from splatam_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=frames, width=width, height=height,
                          seed=0, device=dev)
    return [ds[t] for t in range(frames)]


def phase_offline(dev, frames=10, iters=500, size=(1200, 680)):
    """Offline 3DGS training through ``offline_splatting`` with the Replica
    config as it is, but for the cuts printed."""
    import torch

    from splatam_torch.bench.profile import profile_block
    from splatam_torch.gs.offline import offline_splatting
    from splatam_torch.render.binning import RasterConfig

    config = load_config("gaussian_splatting.py")
    cut(config, ("data", "num_frames"), frames)
    cut(config, ("train", "num_iters_mapping"), iters)
    for key, value in (("start_after", iters // 5), ("densify_every", iters // 5),
                       ("stop_after", 4 * iters // 5),
                       ("remove_big_after", 3 * iters // 5)):
        cut(config, ("train", "densify_dict", key), value)
    seq = synthetic_frames(frames, dev, *size)
    cfg = RasterConfig(**config["raster"])
    # the map before the iterations: the same deterministic per-frame phase,
    # run once more without iterations, outside the counted run
    config0 = copy.deepcopy(config)
    config0["train"]["num_iters_mapping"] = 0
    p0, d0 = frame_metrics(offline_splatting(config0, seq, progress=False,
                                             device=dev),
                           seq, frames, cfg, "offline", "before the iterations")
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.time()
    state = offline_splatting(config, seq, progress=False, device=dev)
    wall = time.time() - t0
    p1, d1 = frame_metrics(state, seq, frames, cfg, "offline", "after")
    launches = read_launches()
    expect = expected_launches(
        cfg.layout, iters + state.counts["densify_renders"] + frames, iters)
    log(f"[offline] layout {cfg.layout}; {iters} iterations at "
        f"{1e3 * state.timing['offline_iter'][0]:.2f} ms each; "
        f"{state.counts['densify_renders']} densification renders; "
        f"{wall:.1f} s in offline_splatting")
    check_launches("offline", launches, expect)
    log(f"[offline] mean PSNR {p0:.2f} -> {p1:.2f} dB, depth L1 {d0:.4f} -> "
        f"{d1:.4f} m")
    if not (math.isfinite(p1) and p1 > p0 and p1 > 20.0 and d1 < 0.05):
        fail("offline training out of bounds: PSNR must rise and end above "
             "20 dB, depth L1 below 0.05 m")
    if dev.type == "cuda":
        profile_block(train_steps(state, seq, cfg, config), 10)
    return dict(psnr_before=p0, psnr=p1, depth_l1=d1,
                ms_per_iter=1e3 * state.timing["offline_iter"][0]), launches


def train_steps(state, seq, cfg, config, iters=10):
    """A block of ``iters`` more offline-training iterations on ``state``'s
    map, for the profiler (a fresh Adam state, frames in turn)."""
    from splatam_torch.core.optim import init_adam
    from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose
    from splatam_torch.gs.offline import gs_step
    from splatam_torch.slam.pipeline import as_frame

    frames = [as_frame(c, d, state.cam.device) for c, d, _, _ in seq]
    lrs = config["train"]["lrs_mapping"]

    def block():
        opt = init_adam({k: state.params[k] for k in GAUSSIAN_KEYS})
        for it in range(iters):
            t = it % len(frames)
            gs_step(state.params, opt, *get_pose(state.params, t), *frames[t],
                    state.cam, cfg, lrs)

    return block


def phase_post_opt(dev, slam_state, frames, iters=300, size=(1200, 680)):
    """Post-SLAM refinement: the SLAM map through ``save_params`` and
    ``post_splatam_opt`` with the Replica config, cut as printed."""
    import torch

    from splatam_torch.bench.profile import profile_block
    from splatam_torch.gs.post_opt import post_splatam_opt
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.slam.pipeline import SlamState
    from splatam_torch.utils.checkpoint import params_from_checkpoint, save_params

    path = save_params(
        slam_state.params, slam_state.variables,
        os.path.join(ROOT, "build", "smoke"), intrinsics=slam_state.intrinsics,
        first_w2c=slam_state.first_w2c,
        gt_w2c_all_frames=slam_state.gt_w2c_all,
    )
    ckpt = dict(np.load(path))
    config = load_config("post_splatam_opt.py")
    cut(config, ("data", "num_frames"), frames)
    cut(config, ("train", "num_iters_mapping"), iters)
    seq = synthetic_frames(frames, dev, *size)
    cfg = RasterConfig(**config["raster"])
    loaded = SlamState()
    loaded.params, loaded.variables = params_from_checkpoint(ckpt, dev)
    loaded.cam = slam_state.cam
    p0, d0 = frame_metrics(loaded, seq, frames, cfg, "post_opt", "loaded map")
    del loaded
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.time()
    state = post_splatam_opt(config, seq, ckpt, progress=False, device=dev)
    wall = time.time() - t0
    launches = read_launches()
    p1, d1 = frame_metrics(state, seq, frames, cfg, "post_opt", "refined")
    check_launches("post_opt", launches,
                   expected_launches(cfg.layout, iters, iters))
    log(f"[post_opt] {iters} iterations at "
        f"{1e3 * state.timing['offline_iter'][0]:.2f} ms each, {wall:.1f} s; "
        f"PSNR {p0:.2f} -> {p1:.2f} dB, depth L1 {d0:.4f} -> {d1:.4f} m")
    if not (math.isfinite(p1) and p1 >= p0 - 0.5):
        fail("refinement lost more than 0.5 dB of PSNR")
    if dev.type == "cuda":
        profile_block(train_steps(state, seq, cfg, config), 10)
    return dict(psnr_loaded=p0, psnr=p1,
                ms_per_iter=1e3 * state.timing["offline_iter"][0]), launches


def gain_candidates(c2w):
    """8 candidate poses [tx ty tz qx qy qz qw] around the camera pose
    ``c2w``: the view itself, six moved 10 cm along +-x, +-y, +-z, and the
    view moved 2.5 m back along its optical axis (tests/test_realtime.py)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(c2w[:3, :3]).as_quat()  # x, y, z, w
    offsets = [np.zeros(3)] + [sign * 0.1 * e for e in np.eye(3)
                               for sign in (1.0, -1.0)]
    offsets.append(-2.5 * c2w[:3, 2])
    return [np.concatenate([c2w[:3, 3] + o, q]) for o in offsets]


def phase_realtime(dev, frames=20, width=1200, height=680, mc=40,
                   requests=(5, 10, 15), iters=(40, 60)):
    """The realtime path through ``realtime_slam`` with the Replica config
    (its tracking and mapping iterations ``iters``) and the realtime CLI's
    gain defaults, gain requests before ``requests``; launches counted per
    call site."""
    import torch

    from splatam_torch.bench.profile import profile_block
    from splatam_torch.data.synthetic import SyntheticDataset
    from splatam_torch.eval.ate import evaluate_ate, trajectory_from_params
    from splatam_torch.realtime import GainConfig, ReplaySource, realtime_slam
    from splatam_torch.realtime.handler import ActiveViewHandler

    config = load_config("splatam.py")
    log(f"[cut] frames: the sequence -> {frames}")
    if iters != (40, 60):
        cut(config, ("tracking", "num_iters"), iters[0])
        cut(config, ("mapping", "num_iters"), iters[1])
    ds = SyntheticDataset(num_frames=frames, width=width, height=height,
                          seed=0, device=dev)
    source = ReplaySource(ds, {t: gain_candidates(ds.poses[t - 1])
                               for t in requests})
    gain_cfg = GainConfig(k_sil=1000.0, k_eig=0.1, k_sum=1.0, monte_carlo=mc)

    sites = {site: {k: 0 for k in KERNEL_NAMES} for site in ("gains", "h_train")}
    originals = {"gains": ActiveViewHandler.compute_gains,
                 "h_train": ActiveViewHandler.recompute_h_train_inv}

    def counted(site):
        def call(*args, **kwargs):
            before = read_launches()
            out = originals[site](*args, **kwargs)
            for k, v in read_launches().items():
                sites[site][k] += v - before[k]
            return out
        return call

    ActiveViewHandler.compute_gains = counted("gains")
    ActiveViewHandler.recompute_h_train_inv = counted("h_train")
    try:
        reset_launches()
        t0 = time.time()
        state, handler = realtime_slam(config, source, gain_cfg,
                                       progress=False, device=dev)
        wall = time.time() - t0
        launches = read_launches()
    finally:
        ActiveViewHandler.compute_gains = originals["gains"]
        ActiveViewHandler.recompute_h_train_inv = originals["h_train"]

    c, hc = state.counts, handler.counts
    poses = sum(min(t + 1, mc) for t in range(frames))
    if hc != {"h_train_poses": poses, "gain_candidates": 8 * len(requests)}:
        fail(f"realtime: Fisher poses and candidates {hc}, expected "
             f"{poses} and {8 * len(requests)}")
    run_iters = c["tracking_iters"] + c["mapping_iters"]
    slam_site = {k: launches[k] - sites["gains"][k] - sites["h_train"][k]
                 for k in KERNEL_NAMES}
    expect_slam = expected_launches(
        state.layout, run_iters + c["densify_renders"], run_iters)
    expect_slam["B1"] += frames  # the dataset's renders (aligned)
    for site, got, expect in (
            ("realtime slam", slam_site, expect_slam),
            ("realtime h_train", sites["h_train"],
             dict(expected_launches("aligned", poses, 0), B4=poses)),
            ("realtime gains", sites["gains"],
             dict(expected_launches("aligned", hc["gain_candidates"], 0),
                  B4=hc["gain_candidates"]))):
        check_launches(site, got, expect)
    if (c["tracking_iters"] != iters[0] * (frames - 1)
            or c["mapping_iters"] != iters[1] * frames):
        fail(f"realtime iterations {c} are not {iters} per frame")

    hinv = handler.h_train_inv
    n = state.params["means3D"].shape[0]
    if hinv is None or hinv.shape != (n, 4) or not np.all(hinv > 0):
        fail(f"realtime: h_train_inv {None if hinv is None else hinv.shape} "
             f"is not a positive ({n}, 4) table")
    for t, gains in zip(requests, source.published):
        log(f"[realtime] gains before frame {t}: "
            + " ".join(f"{g['sil']:.1f}/{g['eig']:.4g}" for g in gains)
            + " (sil/eig per candidate)")
        if not all(math.isfinite(g["gain"]) and g["eig"] > 0 for g in gains):
            fail(f"realtime: gains before frame {t} not finite with EIG > 0")
        if not gains[-1]["sil"] > gains[0]["sil"]:
            fail(f"realtime: the far pose's sil {gains[-1]['sil']} does not "
                 f"exceed the current view's {gains[0]['sil']}")
    if len(source.published) != len(requests):
        fail(f"realtime: {len(source.published)} gain lists published")
    gt, est = trajectory_from_params(state.params, state.first_w2c,
                                     state.gt_w2c_all)
    ate = evaluate_ate(gt, est)
    if not ate < 0.03:
        fail(f"realtime ATE {ate} m")
    result = dict(
        ate_m=ate, gaussians=n, s_per_frame=float(np.mean(state.timing["frame"])),
        ms_per_candidate=1e3 * sum(handler.timing["gains"]) / hc["gain_candidates"],
        ms_per_h_train=1e3 * float(np.mean(handler.timing["h_train"])),
        ms_per_h_train_pose=1e3 * sum(handler.timing["h_train"]) / poses,
    )
    log(f"[realtime] {frames} frames in {wall:.1f} s, layout {state.layout}: "
        f"{result['s_per_frame']:.3f} s/frame (H_train recompute included); "
        f"{result['ms_per_candidate']:.2f} ms per scored candidate, "
        f"{result['ms_per_h_train']:.1f} ms per H_train recompute "
        f"({result['ms_per_h_train_pose']:.2f} ms per pose, {poses} poses); "
        f"ATE {ate:.5f} m, {n} gaussians")
    check_gains_plain(handler, state, gain_candidates(ds.poses[frames - 1]))
    if dev.type == "cuda":
        def block():
            handler.compute_gains(state.params, None,
                                  gain_candidates(ds.poses[frames - 1]))
            handler.recompute_h_train_inv(state.params, None)

        log(f"[realtime] profile: one gain request (8 candidates) and one "
            f"H_train recompute ({min(frames, mc)} poses)")
        profile_block(block, 1)
    torch.cuda.empty_cache()
    return result, launches


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the wrappers of B1, B2, B3a-d (the split forward
    composed by ``compose_split``) and B4 run their plain versions on the
    tensors they are given (on the card too) and count nothing."""
    from splatam_torch.render import raster

    def split_fwd(attrs, binned, grid_x, chunk, carry_depth=True):
        ci, ai, carry, _ = raster.raster_split_int_fwd_plain(
            attrs, binned, grid_x, chunk, carry_depth)
        cp, ap, _ = raster.raster_split_tail_fwd_plain(
            attrs, binned, carry, grid_x, chunk, carry_depth)
        return (*raster.compose_split(binned, ci, ai, cp, ap), carry)

    names = ("raster_fwd_cuda", "raster_bwd_cuda", "raster_split_fwd_cuda",
             "raster_split_int_bwd_cuda", "raster_split_tail_bwd_cuda",
             "fisher_moments_cuda")
    saved = [getattr(raster, name) for name in names]
    for name, fn in zip(names, (
            lambda *a, **k: raster.raster_fwd_plain(*a, **k)[:2],
            raster.raster_bwd_plain, split_fwd,
            raster.raster_split_int_bwd_plain,
            raster.raster_split_tail_bwd_plain, raster.fisher_moments_plain)):
        setattr(raster, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(raster, name, fn)


def check_gains_plain(handler, state, candidates):
    """``fisher_gains_batch`` through the kernels (B1 + B4, B4's moments in
    3xTF32) and through their plain versions, on the same map and
    candidates: the largest relative difference of the silhouette gain and
    of EIG, and the candidates' order by gain, which must not change."""
    import torch

    got = handler.compute_gains(state.params, None, candidates)
    torch.cuda.synchronize()
    with plain_kernels():
        ref = handler.compute_gains(state.params, None, candidates)

    def rel(key):
        return max(abs(g[key] - r[key]) / max(abs(r[key]), 1e-30)
                   for g, r in zip(got, ref))

    order = [np.argsort([-g["gain"] for g in gains], kind="stable").tolist()
             for gains in (got, ref)]
    log(f"[realtime] gains on the final map, kernels vs plain versions "
        f"({len(candidates)} candidates): largest relative difference sil "
        f"{rel('sil'):.3g}, EIG {rel('eig'):.3g}; order by gain "
        f"{'unchanged' if order[0] == order[1] else 'CHANGED'} (kernels "
        f"{order[0]}, plain {order[1]}); EIG kernels "
        + " ".join(f"{g['eig']:.6g}" for g in got) + ", plain "
        + " ".join(f"{r['eig']:.6g}" for r in ref))
    if order[0] != order[1]:
        fail(f"realtime: B4's moments change the candidates' order by gain: "
             f"{order[0]} against the plain versions' {order[1]}")


BENCH_ITERS = 10  # bench.py's chained iterations, binning frozen for all 10
# The probes' iterations per case (the TPU tools' defaults) and P2's reps:
# the tool's 0 and 16, and 256, where the f32 chains leave the HBM bound.
PROBE_ITERS = {"P1": 30, "P2": 20, "P3": 20, "P4": 20}
P2_REPS = (0, 16, 256)
P2_CHECK_REPS = 3  # at 16 the mul_add, exp and roll chains run to overflow,
# and an FMA's single rounding against two then grows 2x per rep
P4_TOL = 1e-4  # of the largest magnitude: 8000 blocks' sums in atomic order
# P3: every case at these reps, each output held to P3_TOL of its own
# largest magnitude with no absolute floor (every pass scales by 1e-3, so
# the mxu outputs are tiny). mxu at reps 1 holds one pass alone, where a
# wrong triangle or a lost bf16 term is ~1e-3 of scale; in chain and dual
# the FMA steps after each pass damp its errors ~100x, so mxu carries the
# pass's check.
P3_CHECK_REPS = (0, 1, 4)
P3_TOL = 1e-4


def phase_bench(dev, bench_size, rng, errs):
    """``[bench]``: B1-B3d at the benchmark's chunk (256) on its own trimmed
    streams against their plain versions; then ``python -m
    splatam_torch.bench`` (split, then aligned) as the main path, with
    exact launch counts; then each run under the profiler."""
    import dataclasses

    import torch

    from splatam_torch.bench.__main__ import main as bench_main
    from splatam_torch.bench.profile import profile_block
    from splatam_torch.bench.scene import setup

    n, w, h = bench_size
    prog = setup(None, n=n, w=w, h=h, device=dev)
    aligned = dataclasses.replace(
        prog, cfg=dataclasses.replace(prog.cfg, layout="aligned"))
    attrs, split_bins, gx = prog.stream_inputs()
    _, aligned_bins, _ = aligned.stream_inputs()  # the same trim caps
    al = Setup(attrs, aligned_bins, gx, MAP_FEATS, prog.cfg.chunk)
    sp = Setup(attrs, split_bins, gx, al.nfeat, prog.cfg.chunk)
    name = f"bench_c{prog.cfg.chunk}"
    compare_kernels(name, al, rng, errs)
    compare_split_kernels(name, sp, al, rng, errs)
    if split_bins.tmeta.shape[0] == 0:
        fail("the bench's split stream has no tail chunk: B3b/B3d would not "
             "launch and the counts below would not hold")
    del prog, aligned, attrs, split_bins, aligned_bins, al, sp
    torch.cuda.empty_cache()

    reset_launches()
    runs = {layout: bench_main(["--n", str(n), "--w", str(w), "--h", str(h),
                                layout])
            for layout in ("split", "aligned")}
    launches = read_launches()
    expect = {k: 0 for k in KERNEL_NAMES}
    for layout in runs:  # the trim probe's forward, a warm-up run, a timed run
        for k, v in expected_launches(layout, 1 + 2 * BENCH_ITERS,
                                      2 * BENCH_ITERS).items():
            expect[k] += v
    check_launches("bench", launches, expect)
    for layout, r in runs.items():
        prog = r["program"]
        if not math.isfinite(r["loss"]):
            fail(f"bench {layout}: the loss is not finite")
        log(f"[bench] {layout}: rasterizer_fwd_bwd_throughput {r['mpix_s']} "
            f"Mpix/s, {r['ms_per_iter']} ms per iteration, "
            f"{prog.num_kept} instances after the trim "
            f"({prog.num_kept_untrimmed} before), loss {r['loss']}")
        log(f"[bench] profile of one run of {prog.iters} iterations ({layout})")
        profile_block(prog.run, prog.iters)
    return {k: (r["ms_per_iter"], r["mpix_s"]) for k, r in runs.items()}, launches


def tri_nnz(chunk):
    """Non-zeros of a triangular 0/1 (chunk, chunk) matrix."""
    return chunk * (chunk + 1) // 2


def phase_probes(dev, bench_size, errs, p2_steps=2000, p3_steps=2000,
                 p4_steps=8000):
    """``[probes]``: P1-P4 each against its plain version at the tools'
    sizes (P1 on the bench's aligned stream), then each probe's run as the
    main path (exact launch counts), its tables, and the rates against the
    card's peaks. Returns the probes' JSON entries and launches."""
    import torch

    from splatam_torch.bench import (ilp_probe, kernel_ablate, step_overhead,
                                     vpu_probe)
    from splatam_torch.bench.scene import setup
    from splatam_torch.render import raster

    n, w, h = bench_size
    gen = torch.Generator(device=dev).manual_seed(2)
    entries = {}

    # P1: every stage on the bench's aligned stream
    prog = setup("aligned", n=n, w=w, h=h, device=dev)
    attrs, binned, gx = prog.stream_inputs()
    x = kernel_ablate.ablation_inputs(attrs, binned, gx, prog.cfg.chunk)
    e1 = 0.0
    for stage in kernel_ablate.STAGES:
        got = kernel_ablate.ablate_cuda(stage, x)
        torch.cuda.synchronize()
        ref = kernel_ablate.ablate_plain(stage, x)
        if stage == "full":
            err, scale = check_grad("P1 full vs plain B2", got, ref)
            b2 = raster.raster_bwd_cuda(attrs, binned.sorted_gid, binned.ranges,
                                        gx, x.chunk, x.color, x.aux,
                                        x.g_color, x.g_aux, x.nfeat, False)
            torch.cuda.synchronize()
            err_b2, _ = check_grad("P1 full vs B2", got, b2)
            log(f"[probes] P1 full: vs plain B2 {err:.3g}, vs B2 {err_b2:.3g} "
                f"(scale {scale:.3g}, limit {GRAD_TOL:g} of scale)")
        else:
            err = check_close(f"P1 {stage}", got, ref, FWD_ATOL)
            log(f"[probes] P1 {stage}: max err {err:.3g} (scale "
                f"{float(ref.abs().max()):.3g})")
        e1 = max(e1, err)
    p1_plain = cuda_ms(lambda: kernel_ablate.ablate_plain("full", x), 2, warmup=0)
    al = Setup(attrs, binned, gx, MAP_FEATS, x.chunk)
    _, _, evaluated = raster.raster_fwd_plain(*al.args, False)
    _, p1_bound, pairs = kernel_bounds(al, evaluated, x.nfeat)
    del prog, attrs, binned, x, al, evaluated
    torch.cuda.empty_cache()

    # P2: every op and dtype, at the tool's size
    shape = (256, p2_steps * vpu_probe.CHUNK)
    e2 = 0.0
    for dname, ops in vpu_probe.CASES:
        dt = vpu_probe.DTYPES[dname]
        x = (torch.rand(shape, generator=gen, device=dev) * 0.6 + 0.2).to(dt)
        for op in ops:
            got = vpu_probe.ops_cuda(x, op, P2_CHECK_REPS).float()
            torch.cuda.synchronize()
            ref = vpu_probe.ops_plain(x, op, P2_CHECK_REPS).float()
            if dname == "bfloat16":  # both round after every op
                check_equal(f"P2 {dname} {op}", got, ref)
                err = 0.0
            else:
                err = check_close(f"P2 {dname} {op}", got, ref, FWD_ATOL)
            e2 = max(e2, err)
        del x
    x06 = torch.full(shape, 0.6, device=dev)
    p2_plain = cuda_ms(lambda: vpu_probe.ops_plain(x06, "mul_add", 16), 2,
                       warmup=0)
    del x06
    log(f"[probes] P2: every op and dtype at reps {P2_CHECK_REPS} within "
        f"{FWD_ATOL:g} + {FWD_RTOL:g} rel (f32), exact (bf16); max err {e2:.3g}")

    # P3: every case at reps 0, 1 and 4
    a = torch.rand((16, p3_steps * 128), generator=gen, device=dev)
    b = torch.rand((16, p3_steps * 128), generator=gen, device=dev)
    e3 = 0.0
    for case in ilp_probe.CASES:
        for reps in P3_CHECK_REPS:
            ga, gb = ilp_probe.ilp_cuda(a, b, case, reps)
            torch.cuda.synchronize()
            ra, rb = ilp_probe.ilp_plain(a, b, case, reps)
            rel = []
            for tag, got, ref in (("a", ga, ra), ("b", gb, rb)):
                err, scale = check_scaled(f"P3 {case} {reps} {tag}", got, ref,
                                          P3_TOL)
                e3 = max(e3, err)
                rel.append(f"{tag} {err:.3g} of {scale:.3g}")
            log(f"[probes] P3 {case} reps {reps}: max err {', '.join(rel)}")
    p3_plain = cuda_ms(lambda: ilp_probe.ilp_plain(a, b, "chain", 4), 2,
                       warmup=0)
    del a, b
    log(f"[probes] P3: every case at reps {P3_CHECK_REPS} within {P3_TOL:g} "
        f"of each output's largest magnitude")

    # P4: every body, permuted index table
    stream, blk = step_overhead.inputs(p4_steps, dev)
    e4 = 0.0
    for body in step_overhead.BODIES:
        got = step_overhead.step_cuda(stream, blk, body)
        torch.cuda.synchronize()
        ref = step_overhead.step_plain(stream, blk, body)
        err = max_err(got, ref)
        scale = float(ref.abs().max())
        if err > P4_TOL * scale and err > 0:
            fail(f"P4 {body}: max err {err:.3g} against scale {scale:.3g}")
        log(f"[probes] P4 {body}: max err {err:.3g} (scale {scale:.3g}, "
            f"limit {P4_TOL:g} of scale)")
        e4 = max(e4, err)
    p4_plain = cuda_ms(lambda: step_overhead.step_plain(stream, blk, "mxu"), 2,
                       warmup=0)
    del stream, blk
    torch.cuda.empty_cache()

    # the main path: each probe's run, at the tools' defaults
    reset_launches()
    p1 = kernel_ablate.run(n, w, h, iters=PROBE_ITERS["P1"], device=dev)
    p2 = vpu_probe.run(p2_steps, PROBE_ITERS["P2"], P2_REPS, device=dev)
    p3 = ilp_probe.run(p3_steps, 4, PROBE_ITERS["P3"], device=dev)
    p4 = step_overhead.run(p4_steps, PROBE_ITERS["P4"], device=dev)
    launches = read_launches()
    expect = {k: 0 for k in KERNEL_NAMES}
    expect["B1"] = 2  # the bench setup's trim probe, the ablation's forward
    nstages = len(kernel_ablate.STAGES)
    expect["P1"] = nstages * (1 + PROBE_ITERS["P1"])
    expect["P2"] = (sum(len(ops) for _, ops in vpu_probe.CASES) * len(P2_REPS)
                    * (1 + PROBE_ITERS["P2"]))
    expect["P3"] = len(ilp_probe.CASES) * 2 * (1 + PROBE_ITERS["P3"])
    expect["P4"] = len(step_overhead.BODIES) * (1 + PROBE_ITERS["P4"])
    check_launches("probes", launches, expect)

    # rates against the card's peaks
    elems = 256 * 128  # one op over one (256, 128) block: P2's, P3's, P4's
    fma_elem_s = {"float32": F32_PEAK_FLOPS / 2, "bfloat16": BF16X2_PEAK_FLOPS / 2}
    for dname, ops in vpu_probe.CASES:
        for op in ops:
            lo, hi = P2_REPS[1], P2_REPS[2]
            ns = (p2[(dname, op, hi)] - p2[(dname, op, lo)]) * 1e6 / p2_steps / (hi - lo)
            rate = elems / ns * 1e9  # element-ops per second
            vs = (f"{rate / SFU_OPS_S:.2f}x the SFU rate" if op in
                  ("exp", "log", "log1p") else
                  f"{rate / fma_elem_s[dname]:.1%} of the {dname} FMA rate")
            log(f"[probes] P2 rate {dname:8s} {op:7s}: {rate / 1e12:.3f} T "
                f"element-ops/s at reps {lo}->{hi} ({vs})")
    steps_ns = {k: v * 1e6 / p3_steps for k, v in p3.items()}
    vpu_ns = steps_ns[("vpu", 4)] - steps_ns[("vpu", 0)]
    mxu_ns = steps_ns[("mxu", 4)] - steps_ns[("mxu", 0)]
    vpu_flops = elems * 8 * 4 * 3  # x * x * -0.5 + 0.6: a mul and an FMA
    pass_flops = 2 * 256 * tri_nnz(128) * 2  # two terms, U's non-zeros
    log(f"[probes] P3 rate: vpu {vpu_flops / vpu_ns / 1e3:.2f} TFLOP/s "
        f"({vpu_flops / vpu_ns * 1e9 / F32_PEAK_FLOPS:.1%} of f32 peak); a "
        f"two-term pass {mxu_ns / 4:.2f} ns per block, "
        f"{pass_flops * 4 / mxu_ns / 1e3:.1f} TFLOP/s on U's non-zeros "
        f"({pass_flops * 4 / mxu_ns * 1e9 / BF16_TC_FLOPS:.1%} of the bf16 "
        f"tensor-core peak)")
    for body in step_overhead.BODIES:
        log(f"[probes] P4 {body}: {p4[body] * 1e6 / p4_steps:.2f} ns per block")

    # bounds of the entries' runs: P1 full (B2), P2 f32 mul_add at reps 16,
    # P3 chain at reps 4, P4 mxu
    p2_n = 256 * p2_steps * vpu_probe.CHUNK
    p3_blocks = p3_steps
    entries["P1"] = dict(
        ms=p1["full"], plain_ms=p1_plain, bound=p1_bound, err=e1,
        stages={s: p1[s] for s in kernel_ablate.STAGES})
    entries["P2"] = dict(ms=p2[("float32", "mul_add", 16)], plain_ms=p2_plain,
                         bound=bound_ms(2 * p2_n * 4, 2 * 16 * p2_n), err=e2)
    entries["P3"] = dict(
        ms=p3[("chain", 4)], plain_ms=p3_plain, err=e3,
        bound=bound_ms(4 * 16 * p3_steps * 128 * 4,
                          p3_blocks * elems * 4 * (8 * 3 + 2),
                          p3_blocks * 4 * pass_flops))
    entries["P4"] = dict(
        ms=p4["mxu"], plain_ms=p4_plain, err=e4,
        bound=bound_ms(p4_steps * (16 * 128 * 4 + 4) + elems * 4,
                          p4_steps * elems, p4_steps * 256 * tri_nnz(128) * 2))
    log(f"[probes] P1 bound: B2's on this stream, {pairs} pairs")
    for k, e in entries.items():
        errs[k] = e["err"]
        log(f"[probes] {k}: {e['ms']:.4f} ms, plain {e['plain_ms']:.2f} ms, "
            f"bound {e['bound'][0]:.4f} ms ({e['bound'][1]})")
    return entries, launches


# ---------------------------------------------------------------------------
# [slam_cli]: the SLAM CLI on sequences written to disk
# ---------------------------------------------------------------------------

CLI_FRAMES = 8


def write_png(path, img):
    """A PNG of (H, W, 3) uint8 or (H, W) uint16, with Pillow."""
    from PIL import Image

    Image.fromarray(img).save(path)


def write_jpeg(path, rgb):
    """A JPEG of (H, W, 3) uint8 at quality 95, 4:4:4, with Pillow."""
    from PIL import Image

    Image.fromarray(rgb).save(path, quality=95, subsampling=0)


def _yaml(path, name, k, w, h, depth_scale, crop_edge):
    with open(path, "w") as f:
        f.write(f"dataset_name: '{name}'\ncamera_params:\n"
                f"  image_height: {h}\n  image_width: {w}\n"
                f"  fx: {k[0][0]}\n  fy: {k[1][1]}\n  cx: {k[0][2]}\n"
                f"  cy: {k[1][2]}\n  crop_edge: {crop_edge}\n"
                f"  png_depth_scale: {depth_scale}\n")


def write_replica(root, dev, frames=CLI_FRAMES, size=(1200, 680)):
    """The synthetic sequence in Replica's format under ``root``/room0:
    results/frame%06d.jpg, depth%06d.png (depth x 6553.5 as uint16),
    traj.txt (a row-major c2w per line), and its dataset YAML."""
    from splatam_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=frames, width=size[0], height=size[1],
                          seed=0, device=dev)
    seq = os.path.join(root, "room0", "results")
    os.makedirs(seq, exist_ok=True)
    lines = []
    for i in range(frames):
        color, depth, _, pose = ds[i]
        write_jpeg(os.path.join(seq, f"frame{i:06d}.jpg"),
                   np.round(color).astype(np.uint8))
        write_png(os.path.join(seq, f"depth{i:06d}.png"),
                  np.round(depth[..., 0] * 6553.5).astype(np.uint16))
        lines.append(" ".join(repr(float(v)) for v in pose.ravel()))
    with open(os.path.join(root, "room0", "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    yaml = os.path.join(root, "replica.yaml")
    _yaml(yaml, "replica", ds.k, *size, 6553.5, 0)
    return yaml


def write_tum(root, dev, frames=CLI_FRAMES, size=(640, 480)):
    """The synthetic sequence in TUM RGB-D's format under ``root``/
    rgbd_dataset_freiburg1_desk: rgb/ and depth/ PNGs (depth x 5000 as
    uint16, stamped 5 ms after the color), rgb.txt, depth.txt and
    groundtruth.txt at 30 Hz, and a dataset YAML with TUM's crop_edge 8."""
    from scipy.spatial.transform import Rotation

    from splatam_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(num_frames=frames, width=size[0], height=size[1],
                          seed=0, device=dev)
    seq = os.path.join(root, "rgbd_dataset_freiburg1_desk")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    rgb, dep = ["# color images"], ["# depth maps"]
    gt = ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(frames):
        color, depth, _, pose = ds[i]
        t = 1305031102.0 + i / 30.0
        write_png(os.path.join(seq, "rgb", f"{t:.6f}.png"),
                  np.round(color).astype(np.uint8))
        write_png(os.path.join(seq, "depth", f"{t + 0.005:.6f}.png"),
                  np.round(depth[..., 0] * 5000.0).astype(np.uint16))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.005:.6f} depth/{t + 0.005:.6f}.png")
        q = Rotation.from_matrix(pose[:3, :3].astype(np.float64)).as_quat()
        gt.append(f"{t:.6f} " + " ".join(repr(float(v)) for v in pose[:3, 3])
                  + " " + " ".join(repr(float(v)) for v in q))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                        ("groundtruth.txt", gt)):
        with open(os.path.join(seq, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    yaml = os.path.join(root, "tum.yaml")
    _yaml(yaml, "tum", ds.k, *size, 5000.0, 8)
    return yaml


def experiment_file(path, base, overrides):
    """Write an experiment file that loads the shipped config ``base`` as it
    is and applies ``overrides`` ((key path, value) pairs), each printed as
    a [cut] line."""
    from splatam_torch.run.common import load_experiment_config

    config = load_experiment_config(base)
    for keys, value in overrides:
        cut(config, keys, value)
    with open(path, "w") as f:
        f.write(
            "import importlib.util\nimport json\n\n"
            f"_spec = importlib.util.spec_from_file_location('base', {base!r})\n"
            "_mod = importlib.util.module_from_spec(_spec)\n"
            "_spec.loader.exec_module(_mod)\nconfig = _mod.config\n"
            f"for _keys, _value in json.loads({json.dumps(overrides)!r}):\n"
            "    _d = config\n    for _k in _keys[:-1]:\n        _d = _d[_k]\n"
            "    _d[_keys[-1]] = _value\n")
    return config


def data_line():
    """The host's image and YAML libraries, the native decoder's build, and
    the decoder the loaders use."""
    import importlib.util

    from splatam_torch import native
    from splatam_torch.data import base

    mods = {m: importlib.util.find_spec(m) is not None
            for m in ("imageio", "PIL", "cv2", "yaml")}
    built = native.native_available()
    log("[data] imports: " + ", ".join(f"{m} {'yes' if ok else 'no'}"
                                      for m, ok in mods.items())
        + "; native decoder (g++ with jpeglib.h and png.h): "
        + ("built" if built else f"not built ({native.build_error})")
        + f"; the loaders decode with {base.IMREAD_DECODER}")
    if base.IMREAD_DECODER is None:
        fail("[data] neither imageio nor Pillow imports: the loaders cannot "
             "decode")


def run_cli(tag, exp, config, dev):
    """``splatam_torch.run.slam.main`` on ``exp`` (whose config is
    ``config``) with every kernel's count set to 0 before and read after,
    the evaluation's launches apart. Returns (state, results, launches,
    wall seconds)."""
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.run import slam

    eval_sequence = slam.eval_sequence
    evals = {}

    def counted(*args, **kwargs):
        before = read_launches()
        out = eval_sequence(*args, **kwargs)
        evals.update({k: v - before[k] for k, v in read_launches().items()})
        return out

    slam.eval_sequence = counted
    try:
        reset_launches()
        t0 = time.time()
        state, results = slam.main([exp, "--device", str(dev)])
        wall = time.time() - t0
        launches = read_launches()
    finally:
        slam.eval_sequence = eval_sequence
    if results is None:
        fail(f"slam_cli {tag}: the evaluation failed")
    c = state.counts
    iters = c["tracking_iters"] + c["mapping_iters"]
    # a tracking-loss figure renders twice: its loss and its images
    expect = expected_launches(
        state.layout, iters + c["densify_renders"] + c["progress_renders"]
        + 2 * c["tracking_figures"], iters)
    # the eval's renders: the config's raster layout (split by default)
    expect_eval = expected_launches(
        RasterConfig(**config.get("raster", {})).layout, results["frames"], 0)
    check_launches(f"slam_cli {tag} eval", evals, expect_eval)
    for k, v in expect_eval.items():
        expect[k] += v
    check_launches(f"slam_cli {tag}", launches, expect)
    return state, results, launches, wall


def phase_slam_cli(dev, frames=CLI_FRAMES):
    """``python -m splatam_torch.run.slam`` (its ``main``) with the shipped
    Replica, SplaTAM-S and TUM configs on synthetic sequences written in
    those datasets' formats, at the configs' own sizes, iterations and keys;
    then a resume from the Replica run's checkpoint at frame 4."""
    import shutil

    import torch

    from splatam_torch.core.params import num_gaussians

    data_line()
    root = os.path.join(ROOT, "build", "slam_cli")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    t0 = time.time()
    runs = []
    yaml = write_replica(os.path.join(data, "Replica"), dev, frames)
    for name in ("splatam.py", "splatam_s.py"):
        extra = ([(("save_checkpoints",), True),
                  (("checkpoint_interval",), 4)]
                 if name == "splatam.py" else [])
        runs.append(("replica/" + name, os.path.join(data, "Replica"), yaml,
                     extra))
    yaml = write_tum(os.path.join(data, "TUM"), dev, frames)
    runs.append(("tum/splatam.py", os.path.join(data, "TUM"), yaml, []))
    log(f"[slam_cli] sequences written in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    results, total = {}, {k: 0 for k in KERNEL_NAMES}
    for name, basedir, yaml, extra in runs:
        tag = name.replace("/", "_").replace(".py", "")
        workdir = os.path.join(root, "experiments", tag)
        exp = os.path.join(root, f"{tag}.py")
        log(f"[slam_cli] {name}:")
        config = experiment_file(
            exp, os.path.join(ROOT, "configs", name),
            [(("data", "basedir"), basedir),
             (("data", "gradslam_data_cfg"), yaml),
             (("workdir",), workdir),
             (("data", "num_frames"), frames)] + extra)
        state, res, launches, wall = run_cli(tag, exp, config, dev)
        run_dir = os.path.join(workdir, config["run_name"])
        for f in ("params.npz", "splat.ply", os.path.join("eval", "psnr.txt")):
            if not os.path.exists(os.path.join(run_dir, f)):
                fail(f"slam_cli {tag}: {f} was not written")
        if not (math.isfinite(res["ate_rmse"]) and math.isfinite(res["psnr"])):
            fail(f"slam_cli {tag}: ATE {res['ate_rmse']} / PSNR {res['psnr']}")
        if any(state.nonfinite.values()):
            fail(f"slam_cli {tag}: non-finite iterations {state.nonfinite}")
        c = state.counts
        r = dict(
            s_per_frame=(wall - res["eval_s"]) / frames,
            ate_mm=1e3 * res["ate_rmse"], psnr=res["psnr"],
            eval_ms_per_frame=1e3 * res["eval_s"] / res["frames"],
            eval_frames=res["frames"], gaussians=num_gaussians(state.params),
            layout=state.layout, doubled=c["tracking_doubled"],
            tracking_iters=c["tracking_iters"], mapping_iters=c["mapping_iters"])
        log(f"[slam_cli] {name}: {json.dumps(r)}")
        log(f"[slam_cli] {name}: mean ms per iteration tracking "
            f"{1e3 * np.mean(state.timing['tracking_iter']):.2f}, mapping "
            f"{1e3 * np.mean(state.timing['mapping_iter']):.2f}; frames whose "
            f"tracking doubled: {c['tracking_doubled']}")
        results[tag] = r
        for k in KERNEL_NAMES:
            total[k] += launches[k]
        if name == "replica/splatam.py":
            first = state
        else:
            del state
        torch.cuda.empty_cache()

    log("[slam_cli] replica/splatam.py resumed from its frame-4 "
        "checkpoint:")
    exp = os.path.join(root, "replica_splatam_resume.py")
    workdir = os.path.join(root, "experiments", "replica_splatam")
    config = experiment_file(
        exp, os.path.join(ROOT, "configs", "replica", "splatam.py"),
        [(("data", "basedir"), os.path.join(data, "Replica")),
         (("data", "gradslam_data_cfg"), os.path.join(data, "Replica",
                                                      "replica.yaml")),
         (("workdir",), workdir), (("data", "num_frames"), frames),
         (("load_checkpoint",), True), (("checkpoint_time_idx",), 4)])
    state, res, launches, wall = run_cli("replica_resume", exp, config, dev)
    if state.counts["tracking_iters"] != (config["tracking"]["num_iters"]
                                          * (frames - 4)):
        fail(f"slam_cli resume: tracking iterations {state.counts}")
    from splatam_torch.core.params import get_pose

    gap = max(float((get_pose(state.params, t)[1]
                     - get_pose(first.params, t)[1]).abs().max())
              for t in range(frames))
    log(f"[slam_cli] resumed: frames 4-{frames - 1} in {wall:.1f} s, "
        f"{num_gaussians(state.params)} gaussians (the full run "
        f"{num_gaussians(first.params)}), ATE "
        f"{1e3 * res['ate_rmse']:.3f} mm, PSNR {res['psnr']:.2f} dB; "
        f"largest translation gap to the full run's poses {gap:.3g} m")
    results["replica_resume"] = dict(ate_mm=1e3 * res["ate_rmse"],
                                     psnr=res["psnr"], gap_m=gap)
    for k in KERNEL_NAMES:
        total[k] += launches[k]
    del state, first
    torch.cuda.empty_cache()
    return results, total


# ---------------------------------------------------------------------------
# [clis]: the other CLIs, and the SLAM keys, on [slam_cli]'s data
# ---------------------------------------------------------------------------

def importable(module):
    import importlib.util

    return importlib.util.find_spec(module) is not None


def counted_cli(tag, fn, layout, renders, iters, total):
    """Run ``fn()`` (a CLI's ``main``) with every kernel's count set to 0
    before and read after, and hold them to ``renders(result)`` forward
    renders, ``iters`` of them differentiated, in ``layout``; the counts
    are added to ``total``. Returns (the result, wall seconds)."""
    reset_launches()
    t0 = time.time()
    out = fn()
    wall = time.time() - t0
    launches = read_launches()
    check_launches(f"clis {tag}", launches,
                   expected_launches(layout, renders(out), iters))
    for k in KERNEL_NAMES:
        total[k] += launches[k]
    return out, wall


def write_replica_v2(root, dev, frames=CLI_FRAMES, size=(1200, 680),
                     tests=4):
    """The synthetic scene in Replica-V2's layout under ``root``/room_0:
    imap/00 the train split (frames 0..``frames``-1, the [slam_cli]
    sequence's poses), imap/01 the test split (``tests`` poses halfway
    between train poses: the sequence at half speed, odd frames), as
    rgb/rgb_%d.png and depth/depth_%d.png (x 1000 as uint16) with
    traj_w_c.txt; and its dataset YAML."""
    from splatam_torch.data.synthetic import SyntheticDataset

    train = SyntheticDataset(num_frames=frames, width=size[0], height=size[1],
                             seed=0, device=dev)
    half = SyntheticDataset(num_frames=2 * tests, width=size[0],
                            height=size[1], seed=0, motion_scale=0.5,
                            device=dev)
    splits = {"00": [train[t] for t in range(frames)],
              "01": [half[2 * i + 1] for i in range(tests)]}
    for split, items in splits.items():
        folder = os.path.join(root, "room_0", "imap", split)
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(folder, sub), exist_ok=True)
        lines = []
        for i, (color, depth, _, pose) in enumerate(items):
            write_png(os.path.join(folder, "rgb", f"rgb_{i}.png"),
                      np.round(color).astype(np.uint8))
            write_png(os.path.join(folder, "depth", f"depth_{i}.png"),
                      np.round(depth[..., 0] * 1000.0).astype(np.uint16))
            lines.append(" ".join(repr(float(v)) for v in pose.ravel()))
        with open(os.path.join(folder, "traj_w_c.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    yaml = os.path.join(root, "replica_v2.yaml")
    _yaml(yaml, "replicav2", train.k, *size, 1000.0, 0)
    return yaml


def phase_clis(dev, frames=CLI_FRAMES, gs_iters=200, post_iters=100,
               slam_frames=4, size=(1200, 680)):
    """The other CLIs' ``main``s on [slam_cli]'s Replica sequence and map,
    each with the shipped config but for the printed cuts, then
    ``run.slam`` with the SLAM keys the shipped configs leave off."""
    import shutil

    import torch

    from splatam_torch.core.params import num_gaussians
    from splatam_torch.eval.runner import eval_sequence
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.run import (eval_novel_view, export_ply,
                                   gaussian_splatting, post_opt, viz)
    from splatam_torch.run.common import build_dataset
    from splatam_torch.utils.checkpoint import load_params
    from splatam_torch.utils.ply import load_ply

    has = {m: importable(m) for m in ("matplotlib", "open3d", "wandb")}
    log("[clis] imports: " + ", ".join(f"{m} {'yes' if ok else 'no'}"
                                      for m, ok in has.items()))
    # no wandb run may reach the network: a present wandb runs disabled
    os.environ["WANDB_MODE"] = "disabled"
    src = os.path.join(ROOT, "build", "slam_cli")
    replica = os.path.join(src, "data", "Replica")
    replica_exp = os.path.join(src, "replica_splatam.py")
    root = os.path.join(ROOT, "build", "clis")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data = [(("data", "basedir"), replica),
            (("data", "gradslam_data_cfg"), os.path.join(replica, "replica.yaml"))]
    replica_cfg = load_config("splatam.py")
    slam_run = os.path.join(src, "experiments", "replica_splatam",
                            replica_cfg["run_name"])
    results, total = {}, {k: 0 for k in KERNEL_NAMES}

    def layout_of(config):
        return RasterConfig(**config.get("raster", {})).layout

    # -- gaussian_splatting: 8 frames, 200 iterations, the densification
    # schedule scaled as [offline] scales it
    log("[clis] gaussian_splatting (configs/replica/gaussian_splatting.py):")
    exp = os.path.join(root, "gaussian_splatting.py")
    overrides = data + [(("workdir",), os.path.join(root, "gs")),
                        (("data", "num_frames"), frames),
                        (("train", "num_iters_mapping"), gs_iters)]
    for key, value in (("start_after", gs_iters // 5),
                       ("densify_every", gs_iters // 5),
                       ("stop_after", 4 * gs_iters // 5),
                       ("remove_big_after", 3 * gs_iters // 5)):
        overrides.append((("train", "densify_dict", key), value))
    config = experiment_file(exp, os.path.join(ROOT, "configs", "replica",
                                               "gaussian_splatting.py"),
                             overrides)
    (state, res), wall = counted_cli(
        "gaussian_splatting",
        lambda: gaussian_splatting.main([exp, "--device", str(dev)]),
        layout_of(config),
        lambda out: gs_iters + out[0].counts["densify_renders"]
        + out[1]["frames"], gs_iters, total)
    run = os.path.join(root, "gs", config["run_name"])
    for f in ("params.npz", "splat.ply", os.path.join("eval", "psnr.txt")):
        if not os.path.exists(os.path.join(run, f)):
            fail(f"clis gaussian_splatting: {f} was not written")
    if not math.isfinite(res["psnr"]):
        fail(f"clis gaussian_splatting: PSNR {res['psnr']}")
    results["gaussian_splatting"] = dict(
        ms_per_iter=1e3 * state.timing["offline_iter"][0], s=wall,
        psnr=res["psnr"], eval_frames=res["frames"],
        gaussians=num_gaussians(state.params))
    log(f"[clis] gaussian_splatting: {json.dumps(results['gaussian_splatting'])}")
    del state
    torch.cuda.empty_cache()

    # -- post_opt: from the Replica SLAM run's params.npz, 100 iterations
    log("[clis] post_opt (configs/replica/post_splatam_opt.py):")
    exp = os.path.join(root, "post_opt.py")
    config = experiment_file(
        exp, os.path.join(ROOT, "configs", "replica", "post_splatam_opt.py"),
        data + [(("workdir",), os.path.join(root, "post")),
                (("data", "param_ckpt_path"),
                 os.path.join(slam_run, "params.npz")),
                # stride 20 keeps 1 of the sequence's 8 frames: take them all
                (("data", "stride"), 1), (("data", "num_frames"), frames),
                (("train", "num_iters_mapping"), post_iters)])
    dataset = build_dataset(config)
    loaded, _, _ = load_params(os.path.join(slam_run, "params.npz"),
                               device=dev)
    before = eval_sequence(
        dataset, loaded, frames, os.path.join(root, "post_loaded"),
        sil_thres=config["train"]["sil_thres"],
        mapping_iters=config["train"]["num_iters_mapping"],
        add_new_gaussians=True, eval_every=config.get("eval_every", 1),
        raster_cfg=RasterConfig(**config["raster"]), device=dev)
    del loaded, dataset
    (state, res), wall = counted_cli(
        "post_opt", lambda: post_opt.main([exp, "--device", str(dev)]),
        layout_of(config),
        lambda out: post_iters + out[0].counts["densify_renders"]
        + out[1]["frames"], post_iters, total)
    results["post_opt"] = dict(
        ms_per_iter=1e3 * state.timing["offline_iter"][0], s=wall,
        psnr_loaded=before["psnr"], psnr=res["psnr"])
    log(f"[clis] post_opt: {json.dumps(results['post_opt'])}")
    if not (math.isfinite(res["psnr"]) and res["psnr"] >= before["psnr"] - 0.5):
        fail("clis post_opt: the refinement lost more than 0.5 dB of PSNR")
    del state
    torch.cuda.empty_cache()

    # -- export_ply on the Replica SLAM run: the arrays of its splat.ply
    log("[clis] export_ply on the [slam_cli] Replica run:")
    ply = os.path.join(slam_run, "splat.ply")
    written = load_ply(ply)
    path, _ = counted_cli(
        "export_ply", lambda: export_ply.main([replica_exp, "--device",
                                               str(dev)]),
        "aligned", lambda out: 0, 0, total)
    again = load_ply(path)
    if path != ply or written.keys() != again.keys() or any(
            not np.array_equal(written[k], again[k]) for k in written):
        fail("clis export_ply: the PLY does not read back to the SLAM "
             "CLI's splat.ply")
    log(f"[clis] export_ply: {len(again['means3D'])} Gaussians, the same "
        "arrays as the SLAM CLI's splat.ply")

    # -- viz --every 4 on the Replica SLAM run
    log("[clis] viz --every 4 on the [slam_cli] Replica run:")
    (pngs, plot), wall = counted_cli(
        "viz", lambda: viz.main([replica_exp, "--every", "4", "--device",
                                 str(dev)]),
        layout_of(replica_cfg), lambda out: len(out[0]), 0, total)
    from PIL import Image

    sizes = {Image.open(p).size for p in pngs}
    if len(pngs) != (frames + 3) // 4 or sizes != {tuple(size)}:
        fail(f"clis viz: {len(pngs)} PNGs of sizes {sizes}")
    if has["matplotlib"] != (plot is not None and os.path.exists(plot)):
        fail(f"clis viz: trajectory plot {plot} with matplotlib "
             f"{'present' if has['matplotlib'] else 'absent'}")
    log(f"[clis] viz: {len(pngs)} PNGs at {size[0]}x{size[1]} in {wall:.1f} s; "
        + ("trajectory.png written" if plot else
           "matplotlib does not import: no trajectory plot"))
    results["viz"] = dict(pngs=len(pngs), s=wall, plot=plot is not None)

    # -- eval_novel_view, train split: eval_sequence with the frames saved
    log("[clis] eval_novel_view, train split (configs/replica/splatam.py):")
    res, wall = counted_cli(
        "eval_novel_view train", lambda: eval_novel_view.main(
            [replica_exp, "--device", str(dev)]),
        layout_of(replica_cfg), lambda out: out["frames"], 0, total)
    saved = sorted(os.listdir(os.path.join(slam_run, "eval_train",
                                           "rendered_rgb")))
    if len(saved) != res["frames"] or not math.isfinite(res["psnr"]):
        fail(f"clis eval_novel_view train: {saved}, PSNR {res['psnr']}")
    results["eval_train"] = dict(psnr=res["psnr"], frames=res["frames"],
                                 s=wall)
    log(f"[clis] eval_novel_view train: {json.dumps(results['eval_train'])}; "
        f"rendered_rgb/ holds {len(saved)} PNGs")

    # -- eval_novel_view, test split: Replica-V2 layout, the Replica run
    log("[clis] eval_novel_view, test split "
        "(configs/replica_v2/eval_novel_view.py):")
    t0 = time.time()
    v2 = os.path.join(root, "data", "Replica_V2")
    v2_yaml = write_replica_v2(v2, dev, frames, size)
    log(f"[clis] Replica-V2 sequence written in {time.time() - t0:.1f} s")
    exp = os.path.join(root, "eval_novel_view.py")
    config = experiment_file(
        exp, os.path.join(ROOT, "configs", "replica_v2", "eval_novel_view.py"),
        [(("data", "basedir"), v2), (("data", "gradslam_data_cfg"), v2_yaml),
         (("workdir",), os.path.dirname(slam_run)),
         (("run_name",), replica_cfg["run_name"])])
    nvs_dir = os.path.join(slam_run, "eval_nvs")
    res, wall = counted_cli(
        "eval_novel_view test", lambda: eval_novel_view.main(
            [exp, "--device", str(dev)]),
        layout_of(config), lambda out: len(np.loadtxt(
            os.path.join(nvs_dir, "nvs_psnr.txt"), ndmin=1)), 0, total)
    for name in ("psnr", "rmse", "l1", "ssim", "lpips", "valid"):
        if not os.path.exists(os.path.join(nvs_dir, f"nvs_{name}.txt")):
            fail(f"clis eval_novel_view test: nvs_{name}.txt was not written")
    if not math.isfinite(res["psnr"]):
        fail(f"clis eval_novel_view test: NVS PSNR {res['psnr']}")
    results["nvs"] = dict(psnr=res["psnr"], ms_ssim=res["ms_ssim"],
                          valid_frac=res["valid_frac"], s=wall, views=len(
                              np.loadtxt(os.path.join(nvs_dir, "nvs_psnr.txt"),
                                         ndmin=1)))
    log(f"[clis] eval_novel_view test: {json.dumps(results['nvs'])}")
    torch.cuda.empty_cache()

    # -- run.slam with the SLAM keys the shipped configs leave off
    log(f"[clis] run.slam (configs/replica/splatam.py, {slam_frames} frames) "
        "with knn, do_ba, Inria densification in mapping, wandb and the "
        "tracking-loss figures:")
    from splatam_torch.slam import initialize, pipeline

    map_iters = replica_cfg["mapping"]["num_iters"]
    track_lrs = replica_cfg["tracking"]["lrs"]
    overrides = data + [
        (("workdir",), os.path.join(root, "slam_keys")),
        (("data", "num_frames"), slam_frames),
        (("mean_sq_dist_method",), "knn"),
        (("mapping", "do_ba"), True),
        (("mapping", "lrs", "cam_unnorm_rots"), track_lrs["cam_unnorm_rots"]),
        (("mapping", "lrs", "cam_trans"), track_lrs["cam_trans"]),
        (("mapping", "use_gaussian_splatting_densification"), True),
        (("use_wandb",), True),
        (("tracking", "visualize_tracking_loss"), has["matplotlib"])]
    for key, value in (("start_after", map_iters // 5),
                       ("densify_every", map_iters // 5),
                       ("stop_after", 4 * map_iters // 5),
                       ("remove_big_after", 3 * map_iters // 5)):
        overrides.append((("mapping", "densify_dict", key), value))
    exp = os.path.join(root, "slam_keys.py")
    config = experiment_file(exp, os.path.join(ROOT, "configs", "replica",
                                               "splatam.py"), overrides)
    knn_s, ba = [], []
    msd, map_step = initialize.mean_squared_knn_distance, pipeline.map_step

    def timed_knn(points, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.time()
        out = msd(points, *args, **kwargs)
        torch.cuda.synchronize()
        knn_s.append((len(points), time.time() - t))
        return out

    def watched_map_step(params, opt, rot, tran, *args, **kwargs):
        res = map_step(params, opt, rot, tran, *args, **kwargs)
        ba.append(float(torch.maximum((res.cam_rot - rot).abs().max(),
                                      (res.cam_tran - tran).abs().max())))
        return res

    initialize.mean_squared_knn_distance = timed_knn
    pipeline.map_step = watched_map_step
    try:
        state, res, launches, wall = run_cli("slam_keys", exp, config, dev)
    finally:
        initialize.mean_squared_knn_distance = msd
        pipeline.map_step = map_step
    for k in KERNEL_NAMES:
        total[k] += launches[k]
    c = state.counts
    if len(knn_s) != 1:
        fail(f"clis slam_keys: knn ran {len(knn_s)} times, not once at frame 0")
    if not (ba and max(ba) > 0):
        fail("clis slam_keys: bundle adjustment moved no keyframe pose")
    figures = []
    for d, _, files in os.walk(os.path.join(root, "slam_keys", "plots")):
        figures += [os.path.join(os.path.basename(d), f) for f in files]
    r = dict(
        s_per_frame=(wall - res["eval_s"]) / slam_frames,
        ate_mm=1e3 * res["ate_rmse"], psnr=res["psnr"],
        knn_points=knn_s[0][0], knn_ms=1e3 * knn_s[0][1],
        ba_steps=len(ba), ba_max_move=max(ba), gs_densified=c["gs_densified"],
        gaussians=num_gaussians(state.params),
        tracking_figures=c["tracking_figures"], figure_files=len(figures),
        wandb=state.log_fn is not None)
    results["slam_keys"] = r
    log(f"[clis] run.slam with the keys: {json.dumps(r)}")
    log(f"[clis] run.slam: mean ms per iteration tracking "
        f"{1e3 * np.mean(state.timing['tracking_iter']):.2f}, mapping "
        f"{1e3 * np.mean(state.timing['mapping_iter']):.2f}")
    if not math.isfinite(res["ate_rmse"]):
        fail(f"clis slam_keys: ATE {res['ate_rmse']}")
    if c["gs_densified"] < 1:
        fail("clis slam_keys: Inria densification never grew the map")
    # one figure per binning segment of each tracked frame (the JAX rule)
    track = config["tracking"]
    rebin = track.get("rebin_every", 10)
    per = (-(-track["num_iters"] // rebin)
           if rebin and not track.get("fixed_binning", False) else 1)
    want = per * (slam_frames - 1) if has["matplotlib"] else 0
    if c["tracking_figures"] != want or len(figures) != want:
        fail(f"clis slam_keys: {c['tracking_figures']} tracking figures, "
             f"{len(figures)} files, not {want}")
    if any(state.nonfinite.values()):
        fail(f"clis slam_keys: non-finite iterations {state.nonfinite}")
    del state
    torch.cuda.empty_cache()
    return results, total


# ---------------------------------------------------------------------------
# [parallel]: the multi-device modules on the card
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 4  # the ranks the image and the map are split over
BAND_GRAD_TOL = 2e-5  # of scale (tests/test_sharded_pallas.py:22-68)
DEPTH_FLIPS = 1e-3  # share of pixels whose median depth may move > 1e-4
MAP_LRS = {"means3D": 1e-4, "rgb_colors": 2.5e-3, "unnorm_rotations": 1e-3,
           "logit_opacities": 0.05, "log_scales": 1e-3}  # splatam.py's
LEAF_NAMES = ("means", "colors", "opacities", "scales", "quats")


def slam_keyframes(state, frames, n=PARALLEL_RANKS):
    """What ``batched_map_step`` takes from the [slam] phase: its map, its
    camera and layout, and its first ``n`` keyframes' estimated poses (all
    of them where a short run kept fewer)."""
    from splatam_torch.core.params import GAUSSIAN_KEYS, get_pose

    keys = state.keyframe_time_indices[:n]
    return {
        "params": {k: state.params[k].detach().clone() for k in GAUSSIAN_KEYS},
        "cam": state.cam, "layout": state.layout, "frames": frames,
        "keyframes": keys,
        "poses": [get_pose(state.params, t) for t in keys],
    }


class Launches:
    """The launches a run of renders must make, per kernel."""

    def __init__(self):
        self.expect = {key: 0 for key in KERNEL_NAMES}

    def count(self, layout, renders, backwards):
        for key, v in expected_launches(layout, renders, backwards).items():
            self.expect[key] += v


def _bench_inputs(bench_size, dev):
    """``bench.py``'s scene as the five render inputs (numpy), its camera,
    and a fixed cotangent of the colour."""
    import torch

    from splatam_torch.bench.scene import make_scene
    from splatam_torch.render.camera import setup_camera

    p, w, h, k = make_scene(*bench_size)
    opac = (1 / (1 + np.exp(-p["logit_opacities"][:, 0]))).astype(np.float32)
    arrays = (p["means3D"], p["rgb_colors"], opac,
              np.tile(np.exp(p["log_scales"]), (1, 3)), p["unnorm_rotations"])
    cot = torch.tensor(np.random.default_rng(7).normal(
        size=(3, h, w)).astype(np.float32), device=dev)
    return p, arrays, setup_camera(w, h, k, np.eye(4), device=dev), cot


def _prim_inputs(p):
    """The map render_prim_sharded splits: the bench scene made anisotropic
    (so the rotation gradients are signal), and a pose."""
    rng = np.random.default_rng(8)
    n = p["means3D"].shape[0]
    prim = {key: p[key] for key in ("means3D", "rgb_colors",
                                    "unnorm_rotations", "logit_opacities")}
    prim["log_scales"] = (np.tile(p["log_scales"], (1, 3)) + rng.uniform(
        -0.3, 0.3, (n, 3))).astype(np.float32)
    pose = (np.array([0.9998, 0.01, -0.01, 0.005], np.float32),
            np.array([0.02, -0.01, 0.03], np.float32))
    return prim, pose


def _leaves(xs, dev):
    import torch

    return [torch.tensor(a, device=dev, requires_grad=True) for a in xs]


def _prim_leaves(prim, pose, dev):
    import torch

    return ({key: torch.tensor(v, device=dev, requires_grad=True)
             for key, v in prim.items()}, _leaves(pose, dev))


def _loss(out, cot):
    """sum(color * cot) + sum(final T)."""
    return (out.color * cot).sum() + out.final_t.sum()


def _held(label, got, ref, atol, rtol=1e-7):
    """got against ref at atol + rtol * |ref|; returns the max abs error."""
    return check_close(label, got.detach(), ref.detach(), atol, rtol)


def _depth_flips(label, got, ref, share=DEPTH_FLIPS):
    off = float(((got - ref).abs() > 1e-4).float().mean())
    if not off < share:
        fail(f"{label}: median depth moved on {off:.4%} of pixels")
    return off


def _held_render(label, out, aux, ref, ref_aux):
    """A sharded render against the unsharded one: color and final T at
    1e-5, the median depth, the instances and saturation depths."""
    import torch

    _held(f"{label} color", out.color, ref.color, FWD_ATOL)
    _held(f"{label} final T", out.final_t, ref.final_t, FWD_ATOL)
    flips = _depth_flips(f"{label} depth", out.depth, ref.depth)
    if aux.num_instances != ref_aux.num_instances:
        fail(f"{label}: {aux.num_instances} instances, unsharded "
             f"{ref_aux.num_instances}")
    if not torch.equal(aux.sat_depth, ref_aux.sat_depth):
        fail(f"{label}: saturation depths differ")
    return flips


def _grads_held(label, got, ref, tol=BAND_GRAD_TOL, names=None,
                noise=()):
    """Each leaf's gradient within ``tol`` of its own largest magnitude; the
    ``noise`` ones (an isotropic scene's quaternions: rounding noise) within
    ``tol`` of the largest of all."""
    joint = max(float(r.abs().max()) for r in ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        name = names[i] if names else str(i)
        scale = joint if name in noise else float(r.abs().max())
        err = max_err(g, r)
        if err > tol * max(scale, 1e-30) and err > 0:
            fail(f"{label} gradient {name}: max err {err:.3g} against "
                 f"scale {scale:.3g}")


def _prim_reference(prim, pose, cam, cfg, cot6, n_ranks, dev, launches):
    """render_prim_sharded's shards concatenated in this process: the
    render, its aux, each shard's leaves and the pose's."""
    from splatam_torch.parallel.prim_sharded import (
        render_prim_shards,
        shard_slices,
    )

    tq, (rot, tran) = _prim_leaves(prim, pose, dev)
    shards = [{key: v[s].detach().requires_grad_() for key, v in tq.items()}
              for s in shard_slices(tq["means3D"].shape[0], n_ranks)]
    out, aux, records = render_prim_shards(shards, [None] * n_ranks, rot,
                                           tran, cam, cfg)
    _loss(out, cot6).backward()
    launches.count(cfg.layout, n_ranks, n_ranks)
    return out, aux, records, shards, (rot, tran)


def _gloo_card_rank(rank, world, store, out_dir, bench_size, bounds, slam,
                    device="cuda"):
    """One of [parallel]'s gloo ranks, all on the one card: the real
    wrappers at world size ``world``, each rank holding its result against
    the same computation in its own process (the bands or shards in turn),
    and its own launches against the renders it ran."""
    import torch
    import torch.distributed as dist

    from splatam_torch.core.params import GAUSSIAN_KEYS
    from splatam_torch.core.transforms import normalize
    from splatam_torch.parallel.mesh import Mesh, make_mesh
    from splatam_torch.parallel.pallas_sharded import (
        rasterize_bands,
        rasterize_rows_sharded,
    )
    from splatam_torch.parallel.prim_sharded import (
        render_prim_sharded,
        shard_slices,
    )
    from splatam_torch.render.binning import RasterConfig

    global log
    if rank:  # rank 0 speaks for the ranks
        log = lambda *a: None  # noqa: E731
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        reset_launches()
        launches = Launches()
        p, arrays, cam, cot = _bench_inputs(bench_size, dev)
        rb, grb, gcb = bounds
        nr, nc = len(grb) - 1, len(gcb) - 1
        meshes = {"rows": Mesh({"data": 1, "tiles": world}),
                  "grid": Mesh({"ty": nr, "tx": nc})}
        for layout in ("aligned", "split"):
            cfg = RasterConfig(chunk=CHUNK, layout=layout)
            for tag, rows, cols, axes in (("rows", rb, None, ("tiles", None)),
                                          ("grid", grb, gcb, ("ty", "tx"))):
                mesh = meshes[tag]
                u = _leaves(arrays, dev)
                t0 = time.perf_counter()
                out, aux = rasterize_rows_sharded(
                    u[0], u[1], u[2], u[3], normalize(u[4]), cam, cfg, mesh,
                    axis_name=axes[0], band_starts=rows, col_starts=cols,
                    axis_name_x=axes[1])
                _loss(out, cot).backward()
                synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
                r = mesh.index(axes[0])
                c = 0 if cols is None else mesh.index(axes[1])
                live = int(rows[r + 1] > rows[r] and (
                    cols is None or cols[c + 1] > cols[c]))
                launches.count(layout, live, live)
                v = _leaves(arrays, dev)
                ref, ref_aux, cells = rasterize_bands(
                    v[0], v[1], v[2], v[3], normalize(v[4]), cam, cfg, rows,
                    cols)
                _loss(ref, cot).backward()
                n_live = sum(1 for (a, b), (e, f), _ in cells
                             if b > a and f > e)
                launches.count(layout, n_live, n_live)
                label = f"[parallel] gloo x{world} {layout} {tag} rank {rank}"
                _held_render(label, out, aux, ref, ref_aux)
                _grads_held(label, [x.grad for x in u], [x.grad for x in v],
                            names=LEAF_NAMES, noise=("quats",))
                log(f"[parallel] gloo, {world} ranks on one card, {layout} "
                    f"{tag}: rasterize_rows_sharded held to the bands in "
                    f"turn; rank 0 forward + backward {ms:.1f} ms host clock"
                    f" ({nvidia_smi_line()})")
        prim, pose = _prim_inputs(p)
        cot6 = torch.tensor(np.random.default_rng(9).normal(
            size=(6,) + tuple(cot.shape[1:])).astype(np.float32), device=dev)
        cfg = RasterConfig(chunk=CHUNK)
        n = prim["means3D"].shape[0]
        s = shard_slices(n, world)[rank]
        tq, (rot, tran) = _prim_leaves({key: v[s] for key, v in prim.items()},
                                       pose, dev)
        out, aux = render_prim_sharded(tq, None, rot, tran, cam, cfg,
                                       Mesh({"prims": world}))
        _loss(out, cot6).backward()
        launches.count(cfg.layout, 1, 1)
        ref, ref_aux, _, shards, (rot0, tran0) = _prim_reference(
            prim, pose, cam, cfg, cot6, world, dev, launches)
        label = f"[parallel] gloo x{world} prims rank {rank}"
        _held_render(label, out, aux, ref, ref_aux)
        _grads_held(label, [tq[key].grad for key in GAUSSIAN_KEYS],
                    [shards[rank][key].grad for key in GAUSSIAN_KEYS],
                    names=GAUSSIAN_KEYS)
        _grads_held(label + " pose", [rot.grad, tran.grad],
                    [rot0.grad, tran0.grad], names=("rot", "tran"))
        log(f"[parallel] gloo, {world} ranks on one card: render_prim_sharded "
            f"(a shard of {n // world} per rank) held to the shards in turn")
        _batched_step(dev, slam, make_mesh(n_tiles=world // 2, n_data=2),
                      launches.count, f"gloo x{world} rank {rank}")
        got = read_launches()
        check_launches(f"parallel gloo rank {rank}", got, launches.expect)
        with open(os.path.join(out_dir, f"launches{rank}.json"), "w") as f:
            json.dump(got, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_parallel(dev, bench_size=(200_000, 1200, 680), slam=None, reps=3):
    """The multi-device modules on the card, after every other phase: the
    per-band body over 4 row bands and a 4-cell grid, one after another in
    this process, against the unsharded render (both layouts) with each
    band's load and time; ``render_prim_sharded``'s 4 shards in this
    process against the unsharded fused render; then the real wrappers in
    a process group of world size 1 (NCCL, a file store under build/):
    ``rasterize_rows_sharded``, ``render_prim_sharded`` and
    ``batched_map_step`` over 4 keyframes of the [slam] map; and at world
    size 4 over gloo, 4 processes sharing the card, each held to the same
    computation in its own process; a degree-3 SH render through the
    kernels against the plain versions; the dense oracle against B1/B2 and
    the goldens. Launches are counted from here to the end, the ranks'
    too, and must match the renders run."""
    import shutil

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from splatam_torch.core.losses import render_for_loss
    from splatam_torch.core.params import GAUSSIAN_KEYS
    from splatam_torch.core.transforms import normalize
    from splatam_torch.parallel.mesh import Mesh, make_mesh
    from splatam_torch.parallel.pallas_sharded import (
        band_partition,
        equal_bands,
        grid_partition,
        rasterize_band,
        rasterize_bands,
        rasterize_rows_sharded,
        row_loads_from_counts,
    )
    from splatam_torch.parallel.prim_sharded import (
        render_prim_sharded,
        shard_slices,
    )
    from splatam_torch.render.binning import RasterConfig, bin_gaussians_csr
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.render.geometry import grid_dims, preprocess
    from splatam_torch.render.reference import rasterize_dense
    from splatam_torch.render.render_tiled import rasterize_tiled
    from splatam_torch.render.sh import rgb_to_sh_dc

    smi = nvidia_smi_line()
    n_ranks = PARALLEL_RANKS
    p, arrays, cam, cot = _bench_inputs(bench_size, dev)
    n = arrays[0].shape[0]
    w, h = cam.image_width, cam.image_height
    launches = Launches()
    count = launches.count
    result = {}

    def leaves(xs=arrays):
        return _leaves(xs, dev)

    reset_launches()
    # --- the partitions, from the whole view's binning counts ------------
    with torch.no_grad():
        t = [torch.as_tensor(a, device=dev) for a in arrays]
        proj = preprocess(t[0], t[3], normalize(t[4]), cam)
        counts = bin_gaussians_csr(
            proj, cam, RasterConfig(chunk=CHUNK, layout="aligned"),
            opacities=t[2]).counts.cpu().numpy()
        del t, proj
    grid_x, grid_y = grid_dims(cam)
    loads = row_loads_from_counts(counts, grid_x)
    mean = counts.sum() / n_ranks
    rb = band_partition(loads, n_ranks)
    eq = equal_bands(grid_y, n_ranks)
    grb, gcb, cells = grid_partition(counts, grid_x, n_ranks)
    imb = {
        "equal": max(loads[eq[d]: eq[d + 1]].sum()
                     for d in range(n_ranks)) / mean,
        "rows": max(loads[rb[d]: rb[d + 1]].sum()
                    for d in range(n_ranks)) / mean,
        "grid": cells.max() / mean,
    }
    result["imbalance"] = imb
    log(f"[parallel] {n} gaussians at {w}x{h}, {int(counts.sum())} "
        f"instances over {grid_x}x{grid_y} tiles; {n_ranks} ranks: equal "
        f"row bands {eq.tolist()} max/mean {imb['equal']:.3f}, balanced "
        f"rows {rb.tolist()} {imb['rows']:.3f}, grid {list(cells.shape)} "
        f"rows {grb.tolist()} cols {gcb.tolist()} cells "
        f"{cells.reshape(-1).tolist()} {imb['grid']:.3f}")

    # --- bands and cells one after another, against the unsharded render -
    refs = {}
    for layout in ("aligned", "split"):
        cfg = RasterConfig(chunk=CHUNK, layout=layout)
        ref_t = leaves()
        ref, ref_aux = rasterize_tiled(ref_t[0], ref_t[1], ref_t[2], ref_t[3],
                                       normalize(ref_t[4]), cam, cfg=cfg,
                                       device=dev)
        _loss(ref, cot).backward()
        count(layout, 1, 1)
        refs[layout] = (ref, ref_aux, [x.grad for x in ref_t])
        for tag, (rows, cols) in (("rows", (rb, None)), ("grid", (grb, gcb))):
            u = leaves()
            out, aux, band_loads = rasterize_bands(
                u[0], u[1], u[2], u[3], normalize(u[4]), cam, cfg, rows, cols)
            _loss(out, cot).backward()
            live = [bl for bl in band_loads
                    if bl[0][1] > bl[0][0] and bl[1][1] > bl[1][0]]
            count(layout, len(live), len(live))
            label = f"[parallel] {layout} {tag}"
            flips = _held_render(label, out, aux, ref, ref_aux)
            _grads_held(label, [x.grad for x in u], refs[layout][2],
                        names=LEAF_NAMES, noise=("quats",))
            v = leaves()
            per_band = []
            for (r0, r1), (c0, c1), inst in live:
                def step(r=(r0, r1), c=(c0, c1)):
                    band, _ = rasterize_band(
                        v[0], v[1], v[2], v[3], normalize(v[4]), cam, cfg,
                        r, None if tag == "rows" else c)
                    (band.color.sum() + band.final_t.sum()).backward()
                per_band.append(cuda_ms(step, reps))
            count(layout, len(live) * (reps + 1), len(live) * (reps + 1))
            result[f"{layout}_{tag}_ms"] = per_band
            mean_inst = sum(bl[2] for bl in live) / n_ranks
            log(f"{label}: held to the unsharded render (depth flips "
                f"{flips:.4%}); per band rows x cols, instances, forward + "
                f"backward ms: " + "; ".join(
                    f"{r0}-{r1} x {c0}-{c1} {inst} {ms:.3f}" for
                    ((r0, r1), (c0, c1), inst), ms in zip(live, per_band))
                + f"; max/mean instances "
                f"{max(bl[2] for bl in live) / mean_inst:.3f}; slowest/mean "
                f"band {max(per_band) / np.mean(per_band):.3f} ({smi})")
        del ref_t

    # --- render_prim_sharded's 4 shards in this process ------------------
    prim, pose = _prim_inputs(p)
    cot6 = torch.tensor(np.random.default_rng(9).normal(
        size=(6, h, w)).astype(np.float32), device=dev)
    cfg_p = RasterConfig(chunk=CHUNK)
    tp, (rot, tran) = _prim_leaves(prim, pose, dev)
    pref, pref_aux = render_for_loss(tp, rot, tran, cam, cfg_p,
                                     gaussians_grad=True, camera_grad=True)
    _loss(pref, cot6).backward()
    count(cfg_p.layout, 1, 1)
    pref_grads = [tp[key].grad for key in GAUSSIAN_KEYS] + [rot.grad,
                                                            tran.grad]
    out, aux, records, shards, (rot2, tran2) = _prim_reference(
        prim, pose, cam, cfg_p, cot6, n_ranks, dev, launches)
    _held_render("[parallel] prims", out, aux, pref, pref_aux)
    for i, (shard, s) in enumerate(zip(shards, shard_slices(n, n_ranks))):
        # each shard's gradients against its slice, at the whole map's scale
        _grads_held(f"[parallel] prims shard {i}",
                    [shard[key].grad for key in GAUSSIAN_KEYS],
                    [g[s] for g in pref_grads[:5]], names=GAUSSIAN_KEYS)
    _grads_held("[parallel] prims pose", [rot2.grad, tran2.grad],
                pref_grads[5:], names=("rot", "tran"))
    log(f"[parallel] render_prim_sharded: {n_ranks} shards of {n // n_ranks}"
        f", {records.shape[0]} records of {records.shape[1]} floats "
        f"concatenated, {aux.num_instances} instances: held to the unsharded "
        f"fused render, each shard's gradients to its slice")
    del shards, records

    # --- the wrappers in a process group of world size 1 ------------------
    store = os.path.join(ROOT, "build", f"parallel_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        for layout in ("aligned", "split"):
            cfg = RasterConfig(chunk=CHUNK, layout=layout)
            u = leaves()
            out, aux = rasterize_rows_sharded(u[0], u[1], u[2], u[3],
                                              normalize(u[4]), cam, cfg, mesh)
            _loss(out, cot).backward()
            count(layout, 1, 1)
            ref, ref_aux, ref_grads = refs[layout]
            _held_render(f"[parallel] {backend} {layout} rows", out, aux, ref,
                         ref_aux)
            _grads_held(f"[parallel] {backend} {layout} rows",
                        [x.grad for x in u], ref_grads, names=LEAF_NAMES,
                        noise=("quats",))
        tq, (rot3, tran3) = _prim_leaves(prim, pose, dev)
        out, aux = render_prim_sharded(tq, None, rot3, tran3, cam, cfg_p,
                                       Mesh({"prims": 1}))
        _loss(out, cot6).backward()
        count(cfg_p.layout, 1, 1)
        _held_render(f"[parallel] {backend} prims", out, aux, pref, pref_aux)
        _grads_held(f"[parallel] {backend} prims",
                    [tq[key].grad for key in GAUSSIAN_KEYS]
                    + [rot3.grad, tran3.grad], pref_grads)
        log(f"[parallel] {backend} at world size 1: rasterize_rows_sharded "
            f"(both layouts) and render_prim_sharded through all-gather, "
            f"reduce-scatter and all-reduce equal the unsharded renders")
        del tq, refs
        if slam is not None:
            result["batched"] = _batched_step(dev, slam, mesh, count, backend)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)

    # --- world size 4 over gloo, the ranks sharing the card ---------------
    if dev.type == "cuda" and slam is not None:
        t0 = time.time()
        share = os.path.join(ROOT, "build", f"parallel_gloo_{os.getpid()}")
        os.makedirs(share, exist_ok=True)
        gloo_store = os.path.join(share, "store")
        try:
            mp.start_processes(
                _gloo_card_rank, nprocs=n_ranks, join=True,
                start_method="spawn",
                args=(n_ranks, gloo_store, share, bench_size, (rb, grb, gcb),
                      slam))
        except Exception as e:  # a rank failed: it printed why
            fail(f"[parallel] the gloo ranks on the card: {e}")
        for r in range(n_ranks):
            with open(os.path.join(share, f"launches{r}.json")) as f:
                for key, v in json.load(f).items():
                    launches.expect[key] += v  # each rank checked its own
                    result.setdefault("rank_launches", {}).setdefault(
                        key, 0)
                    result["rank_launches"][key] += v
        shutil.rmtree(share, ignore_errors=True)
        log(f"[parallel] gloo at world size {n_ranks} on one card "
            f"({n_ranks} processes): rasterize_rows_sharded (rows and grid, "
            f"both layouts), render_prim_sharded and batched_map_step (2x2) "
            f"each held to the same computation in one process, in "
            f"{time.time() - t0:.1f} s; the ranks' launches "
            f"{json.dumps(result['rank_launches'])}")

    # --- a degree-3 SH render through the kernels and the plain versions -
    shs = np.random.default_rng(10).normal(0, 0.2, (n, 16, 3)).astype(
        np.float32)
    shs[:, 0] = rgb_to_sh_dc(torch.as_tensor(p["rgb_colors"])).numpy()
    for layout in ("aligned", "split"):
        cfg = RasterConfig(chunk=CHUNK, layout=layout)
        got = []
        for plain in (False, True):
            ts, tm = leaves((shs, arrays[0]))
            with plain_kernels() if plain else contextlib.nullcontext():
                out, _ = rasterize_tiled(tm, None, arrays[2], arrays[3],
                                         arrays[4], cam, cfg=cfg, device=dev,
                                         shs=ts, sh_degree=3)
                _loss(out, cot).backward()
            got.append((out, ts.grad, tm.grad))
        count(layout, 1, 1)
        (o1, gs1, gm1), (o0, gs0, gm0) = got
        e = max(check_close(f"[parallel] SH {layout} color", o1.color.detach(),
                            o0.color.detach(), FWD_ATOL),
                check_close(f"[parallel] SH {layout} final T",
                            o1.final_t.detach(), o0.final_t.detach(),
                            FINAL_T_ATOL))
        check_grad(f"[parallel] SH {layout} d/dshs", gs1, gs0)
        check_grad(f"[parallel] SH {layout} d/dmeans", gm1, gm0)
        log(f"[parallel] SH degree 3 (16 coefficients) {layout}: kernels "
            f"against the plain versions, forward max err {e:.3g}, eval_sh's "
            f"gradients through the kernels' backward within "
            f"{GRAD_TOL:g} of scale")
        del got, o1, o0

    # --- the dense oracle against B1/B2 and the goldens ------------------
    for name, scene in golden_scenes().items():
        means, colors, opac_g, scales, quats, gw, gh, gk = scene
        cam_g = setup_camera(gw, gh, gk, np.eye(4), device=dev)
        xs = (means, colors, opac_g, scales, quats)
        d = leaves(xs)
        dense = rasterize_dense(d[0], d[1], d[2], d[3], normalize(d[4]), cam_g)
        cot_g = torch.tensor(np.random.default_rng(1).normal(
            size=(3, gh, gw)).astype(np.float32), device=dev)
        _loss(dense, cot_g).backward()
        u = leaves(xs)
        tiled, _ = rasterize_tiled(u[0], u[1], u[2], u[3], normalize(u[4]),
                                   cam_g, cfg=RasterConfig(chunk=CHUNK,
                                                           layout="aligned"),
                                   device=dev)
        _loss(tiled, cot_g).backward()
        count("aligned", 1, 1)
        _held(f"[parallel] oracle {name} color", tiled.color, dense.color,
              FWD_ATOL, FWD_RTOL)
        _held(f"[parallel] oracle {name} final T", tiled.final_t,
              dense.final_t, FINAL_T_ATOL, FWD_RTOL)
        # per-pixel against per-tile order: median-depth tie flips aside
        _depth_flips(f"[parallel] oracle {name} depth", tiled.depth,
                     dense.depth, share=0.01)
        _grads_held(f"[parallel] oracle {name}", [x.grad for x in u[:3]],
                    [x.grad for x in d[:3]], tol=GRAD_TOL,
                    names=LEAF_NAMES[:3])
        g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        np.testing.assert_allclose(dense.color.detach().cpu().numpy(),
                                   g["color"], atol=FWD_ATOL)
        np.testing.assert_allclose(dense.final_t.detach().cpu().numpy(),
                                   g["final_t"], atol=FWD_ATOL)
        np.testing.assert_allclose(dense.depth.detach().cpu().numpy(),
                                   g["depth"], atol=1e-4)
    log("[parallel] dense oracle on the card: B1's forward and B2's "
        "gradients on the three golden scenes held to rasterize_dense, "
        "rasterize_dense held to tests/goldens")

    got = read_launches()
    for key, v in result.get("rank_launches", {}).items():
        got[key] += v
    check_launches("parallel", got, launches.expect)
    return result, got


def _batched_step(dev, slam, mesh, count, tag):
    """``batched_map_step`` over the [slam] map's first keyframes at
    1200x680 with shard_axis="tiles" on ``mesh``, against the mean of the
    single-keyframe gradients and one Adam step."""
    import torch

    from splatam_torch.core.losses import slam_loss
    from splatam_torch.core.optim import init_adam
    from splatam_torch.core.params import GAUSSIAN_KEYS
    from splatam_torch.data.synthetic import SyntheticDataset
    from splatam_torch.parallel.sharded import batched_map_step
    from splatam_torch.render.binning import RasterConfig
    from splatam_torch.slam.pipeline import as_frame

    cam, layout, keys = slam["cam"], slam["layout"], slam["keyframes"]
    ds = SyntheticDataset(num_frames=slam["frames"], width=cam.image_width,
                          height=cam.image_height, seed=0, device=dev)
    frames = [as_frame(*ds[t][:2], dev) for t in keys]
    count("aligned", len(keys), 0)  # the dataset renders its frames (B1)
    ims = torch.stack([f[0] for f in frames])
    depths = torch.stack([f[1] for f in frames])
    rots = torch.stack([r for r, _ in slam["poses"]]).to(dev)
    trans = torch.stack([t for _, t in slam["poses"]]).to(dev)
    b = len(keys)
    params = {key: v.to(dev, copy=True) for key, v in slam["params"].items()}
    old = {key: v.clone() for key, v in params.items()}
    active = torch.ones(params["means3D"].shape[0], dtype=torch.bool,
                        device=dev)
    opt = init_adam(params)
    kw = dict(sil_thres=0.5, use_sil_for_loss=False,
              ignore_outlier_depth_loss=False, loss_w_im=0.5,
              loss_w_depth=1.0)
    synchronize(dev)
    t0 = time.perf_counter()
    _, opt, loss = batched_map_step(
        params, active, opt, rots, trans, ims, depths, cam,
        RasterConfig(chunk=CHUNK, layout=layout, shard_axis="tiles"),
        MAP_LRS, mesh=mesh, **kw)
    loss = float(loss)
    synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / b
    # this rank's keyframes, each rendered once (its band, where the tiles
    # axis splits the image) and differentiated once
    mine = b // mesh.shape["data"]
    count(layout, mine, mine)
    if not math.isfinite(loss):
        fail(f"[parallel] {tag} batched_map_step loss {loss}")
    moved = max(float((params[key] - old[key]).abs().max())
                for key in GAUSSIAN_KEYS)
    if not moved > 0:
        fail(f"[parallel] {tag} batched_map_step did not move the parameters")
    # the reference: each keyframe's gradient alone, their mean
    mean = {key: torch.zeros_like(v) for key, v in old.items()}
    losses = []
    cfg = RasterConfig(chunk=CHUNK, layout=layout)
    for i in range(b):
        g = {key: v.clone().requires_grad_() for key, v in old.items()}
        out = slam_loss(g, rots[i], trans[i], ims[i], depths[i], cam, cfg,
                        tracking=False, **kw)
        grads = torch.autograd.grad(out.loss, [g[key] for key in GAUSSIAN_KEYS])
        for key, gr in zip(GAUSSIAN_KEYS, grads):
            mean[key] += gr / b
        losses.append(float(out.loss.detach()))
    count(layout, b, b)
    if abs(loss - np.mean(losses)) > 1e-5 * abs(np.mean(losses)):
        fail(f"[parallel] {tag} batched_map_step loss {loss} against the "
             f"mean of the keyframes' {np.mean(losses)}")
    # one Adam step (eps 1e-15): its first moments are 0.1 g, its second
    # 0.001 g^2, and the step moves each parameter by lr m^ / (sqrt(v^) +
    # eps); the kernels' atomics reorder sums, so the sign of a gradient
    # that is rounding noise (an isotropic map's rotations) may differ
    # between two runs: the moments are held to the reference, the step
    # to the moments it took
    noise = (("unnorm_rotations",) if params["log_scales"].shape[1] == 1
             else ())
    _grads_held(f"[parallel] {tag} batched m",
                [opt.mu[key] for key in GAUSSIAN_KEYS],
                [0.1 * mean[key] for key in GAUSSIAN_KEYS], GRAD_TOL,
                GAUSSIAN_KEYS, noise)
    _grads_held(f"[parallel] {tag} batched v",
                [opt.nu[key] for key in GAUSSIAN_KEYS],
                [0.001 * mean[key] ** 2 for key in GAUSSIAN_KEYS],
                2 * GRAD_TOL, GAUSSIAN_KEYS, noise)
    for key in GAUSSIAN_KEYS:
        step = MAP_LRS[key] * (opt.mu[key] / 0.1) / (
            torch.sqrt(opt.nu[key] / 0.001) + 1e-15)
        check_scaled(f"[parallel] {tag} batched step {key}", params[key],
                     old[key] - step, 1e-6)
    shape = "x".join(str(v) for v in mesh.shape.values())
    log(f"[parallel] {tag}: batched_map_step over keyframes {keys} of the "
        f"[slam] map ({old['means3D'].shape[0]} gaussians, {layout}) at "
        f"{cam.image_width}x{cam.image_height} on a {shape} (data x tiles) "
        f"mesh: loss {loss:.6f} (the keyframes' mean {np.mean(losses):.6f})"
        f", {ms:.2f} ms per keyframe of the batch ({nvidia_smi_line()}); "
        f"the moments are the mean gradient's, the step Adam's")
    return {"loss": loss, "ms_per_keyframe": ms}


PALLAS = "splatam_tpu/render/pallas_raster.py"
SOURCES = {  # name, source in render/csrc/, the TPU kernel it replaces
    "B1": ("raster_fwd", "raster_fwd.cu", f"{PALLAS}:567"),
    "B2": ("raster_bwd", "raster_bwd.cu", f"{PALLAS}:962"),
    "B3a": ("raster_split_int_fwd", "raster_split_fwd.cu", f"{PALLAS}:1590"),
    "B3b": ("raster_split_tail_fwd", "raster_split_fwd.cu", f"{PALLAS}:1036"),
    "B3c": ("raster_split_int_bwd", "raster_split_bwd.cu", f"{PALLAS}:990"),
    "B3d": ("raster_split_tail_bwd", "raster_split_bwd.cu", f"{PALLAS}:1196"),
    "B4": ("raster_fisher", "raster_fisher.cu", f"{PALLAS}:1495"),
    "P1": ("probe_ablate", "probe_ablate.cu", "tools/kernel_ablate.py:307"),
    "P2": ("probe_ops", "probe_ops.cu", "tools/vpu_probe.py:56"),
    "P3": ("probe_ilp", "probe_ilp.cu", "tools/ilp_probe.py:99"),
    "P4": ("probe_step", "probe_step.cu", "tools/step_overhead.py:103"),
}


def smoke(dev, frames, bench_size=(200_000, 1200, 680), slam_size=None,
          offline=None, post=None, realtime=None, probes=None, slam_cli=None,
          clis=None, parallel=None):
    """Phases 2-12 on ``dev``. Returns (the kernels' JSON entries, a
    one-line summary)."""
    import torch

    t = time.time()
    errs, aligned, split = phase_kernels(dev, bench_size)
    log(f"[kernels] all comparisons within tolerance ({time.time() - t:.1f} s)")
    t = time.time()
    times, bounds = phase_timing(aligned, split, dev)
    del aligned, split
    torch.cuda.empty_cache()
    iteration = {layout: phase_iteration(dev, layout, bench_size=bench_size)
                 for layout in ("aligned", "split")}
    log(f"[timing] done ({time.time() - t:.1f} s)")
    t = time.time()
    bench, bench_launches = phase_bench(dev, bench_size,
                                        np.random.default_rng(3), errs)
    log(f"[bench] phase in {time.time() - t:.1f} s")
    t = time.time()
    probe_entries, probe_launches = phase_probes(dev, bench_size, errs,
                                                 **(probes or {}))
    log(f"[probes] phase in {time.time() - t:.1f} s")
    t = time.time()
    from splatam_torch.bench import fwd_stages

    fwd_stages.run(*bench_size)
    log(f"[fwd_stages] phase in {time.time() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.time()
    slam, launches, slam_state = phase_slam(frames, dev, **(slam_size or {}))
    log(f"[slam] {frames} frames in {time.time() - t:.1f} s")
    t = time.time()
    off, off_launches = phase_offline(dev, **(offline or {}))
    log(f"[offline] phase in {time.time() - t:.1f} s")
    t = time.time()
    post_, post_launches = phase_post_opt(dev, slam_state, frames,
                                          **(post or {}))
    log(f"[post_opt] phase in {time.time() - t:.1f} s")
    slam_kf = slam_keyframes(slam_state, frames)
    del slam_state
    torch.cuda.empty_cache()
    t = time.time()
    rt, rt_launches = phase_realtime(dev, **(realtime or {}))
    log(f"[realtime] phase in {time.time() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.time()
    cli, cli_launches = phase_slam_cli(dev, **(slam_cli or {}))
    log(f"[slam_cli] phase in {time.time() - t:.1f} s")
    t = time.time()
    others, others_launches = phase_clis(dev, **(clis or {}))
    log(f"[clis] phase in {time.time() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.time()
    par, par_launches = phase_parallel(dev, bench_size, slam_kf,
                                       **(parallel or {}))
    del slam_kf
    log(f"[parallel] phase in {time.time() - t:.1f} s")
    # the main paths' launches: the bench, the probes, SLAM, offline
    # training, refinement, realtime, the SLAM CLI, the other CLIs, the
    # multi-device modules
    for k in KERNEL_NAMES:
        launches[k] += (bench_launches[k] + probe_launches[k] + off_launches[k]
                        + post_launches[k] + rt_launches[k] + cli_launches[k]
                        + others_launches[k] + par_launches[k])
    for k, e in probe_entries.items():
        times[k], bounds[k] = (e["ms"], e["plain_ms"]), e["bound"]

    kernels = []
    for k in KERNEL_NAMES:
        kernels.append({
            "name": SOURCES[k][0], "route": "cuda",
            "source": f"splatam_torch/render/csrc/{SOURCES[k][1]}",
            "replaces": SOURCES[k][2],
            "launches": launches[k], "max_abs_err": errs[k],
            "ms": times[k][0], "plain_ms": times[k][1],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": None,
        })
    kernels[KERNEL_NAMES.index("P1")]["stages_ms"] = probe_entries["P1"]["stages"]
    summary = (
        "bench " + ", ".join(f"{lay} {ms:.3f} ms ({mp:.3f} Mpix/s)"
                             for lay, (ms, mp) in bench.items())
        + "; map_step c128 " + ", ".join(f"{lay} {ms:.3f} ms ({mp:.2f} Mpix/s)"
                                         for lay, (ms, mp) in iteration.items())
        + f"; SLAM {slam['s_per_frame']} s/frame; offline "
        f"{off['ms_per_iter']:.2f} ms/iteration, PSNR {off['psnr']:.2f} dB; "
        f"refinement {post_['ms_per_iter']:.2f} ms/iteration, PSNR "
        f"{post_['psnr_loaded']:.2f} -> {post_['psnr']:.2f} dB; realtime "
        f"{rt['s_per_frame']:.3f} s/frame, {rt['ms_per_candidate']:.2f} ms "
        f"per candidate, {rt['ms_per_h_train']:.1f} ms per H_train recompute"
        "; SLAM CLI " + ", ".join(
            f"{tag} {r['s_per_frame']:.2f} s/frame ATE {r['ate_mm']:.2f} mm "
            f"PSNR {r['psnr']:.2f} dB eval {r['eval_ms_per_frame']:.1f} ms/frame"
            for tag, r in cli.items() if "s_per_frame" in r)
        + f"; CLIs: gaussian_splatting "
        f"{others['gaussian_splatting']['ms_per_iter']:.2f} ms/iteration, "
        f"post_opt {others['post_opt']['ms_per_iter']:.2f} ms/iteration, NVS "
        f"PSNR {others['nvs']['psnr']:.2f} dB, SLAM with the keys "
        f"{others['slam_keys']['s_per_frame']:.2f} s/frame (knn "
        f"{others['slam_keys']['knn_ms']:.1f} ms)"
        f"; parallel: {PARALLEL_RANKS} bands max/mean instances "
        + ", ".join(f"{tag} {v:.3f}" for tag, v in par["imbalance"].items())
        + f", batched_map_step {par['batched']['ms_per_keyframe']:.2f} ms "
        f"per keyframe")
    return kernels, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=60,
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
    if args.frames != 60:
        log(f"[cut] [slam] frames: 60 -> {args.frames}")
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
