"""The port's measurement path (``splatam_torch.bench``) against the JAX
package's: the benchmark's program against ``bench.py``, and the plain
versions of the probe kernels P1-P4 against the TPU tools they replace.

Tolerances: the benchmark's loss and P1's per-pixel outputs those of
tests/test_pallas.py (atol 1e-5 / rtol 1e-4; gradients 5e-5 of their
scale); P2 f32 against the tool in Pallas interpret mode 1e-5 / 1e-4
(the last place of exp/log differs); P3 against the tool 1e-4 of each
output's largest magnitude (the order of a matmul's sums differs); P2
bf16 exactly (both round after every op); P4 against a numpy evaluation
1e-5 of the output's largest magnitude (sums over blocks in another order).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from splatam_torch.bench import (fwd_stages, ilp_probe, kernel_ablate,
                                 step_overhead, vpu_probe)
from splatam_torch.bench.__main__ import main as bench_main, measure
from splatam_torch.bench.scene import parse_mode, setup
from splatam_torch.render import raster
from splatam_torch.render.binning import Binned, RasterConfig, bin_gaussians_csr
from splatam_torch.render.geometry import preprocess
from splatam_torch.render.render_tiled import blocks_to_image, image_to_blocks

from tests.test_torch_geometry import jax_scenes, torch_scene  # noqa: F401

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(iters=2, rebin_every=2, n=2000, w=96, h=64)


def _tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


# ---------------------------------------------------------------------------
# The benchmark
# ---------------------------------------------------------------------------


def test_mode_tokens_and_rebin_cadence():
    base = RasterConfig(chunk=256)
    cfg, opts = parse_mode(base, None)
    assert (cfg, opts) == (base, {"trim": True})
    cfg, opts = parse_mode(base, "aligned+c128+notrim")
    assert (cfg.layout, cfg.chunk, opts["trim"]) == ("aligned", 128, False)
    # bench.py's TPU-only levers are accepted and change nothing
    assert parse_mode(base, "perm+roll+align+noalign+sort+scatter+mxu")[0] == base
    with pytest.raises(ValueError):
        parse_mode(base, "split+bogus")
    with pytest.raises(ValueError):
        setup(None, iters=3, rebin_every=2, n=2000, w=96, h=64, device="cpu")
    with pytest.raises(RuntimeError):  # no CUDA here, and no CPU asked for
        setup(None, n=2000, w=96, h=64)


@pytest.fixture(scope="module")
def port_bench():
    """The benchmark's program on the CPU at the small size, measured as
    ``python -m splatam_torch.bench`` measures it: a warm-up run and a
    timed run of 2 iterations."""
    prog = setup(None, device="cpu", **SMALL)
    return dict(measure(prog), program=prog)


def test_bench_cli_prints_one_line(port_bench, capsys):
    import json

    res = port_bench
    assert np.isfinite(res["loss"]) and res["mpix_s"] > 0
    prog = res["program"]
    assert prog.cfg.layout == "split" and prog.cfg.chunk == 256
    assert 0 < prog.num_kept <= prog.num_kept_untrimmed
    capsys.readouterr()
    bench_main(["--device", "cpu", "--n", "300", "--w", "48", "--h", "32",
                "aligned"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "rasterizer_fwd_bwd_throughput"
    assert line["unit"] == "Mpix/s"


@pytest.fixture(scope="module")
def jax_iteration():
    """One iteration of ``bench.py``'s program under one jax.jit: its
    binning at the probe's saturation caps, loss and gradients."""
    import bench

    b = bench.setup(None, **SMALL)

    def one(gauss, sat):
        binned = b["bin_now"](gauss, sat)
        return jax.value_and_grad(lambda g: b["full_loss"](g, binned).loss)(gauss)

    loss, grads = jax.jit(one)(b["gauss"], b["sat0"])
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_bench_iteration_matches_jax(port_bench, jax_iteration):
    prog = port_bench["program"]
    out, grads = prog.loss_and_grads(prog.params,
                                     prog.bin_now(prog.params, prog.sat0))
    jloss, jgrads = jax_iteration
    np.testing.assert_allclose(float(out.loss.detach()), jloss, atol=1e-5,
                               rtol=1e-4)
    assert set(grads) == set(jgrads)
    top = max(np.abs(v).max() for v in jgrads.values())
    for k, g in grads.items():
        # the gaussians are isotropic: the rotations' gradient is zero but
        # for float noise (~1e-9) in both, so it is held to the largest
        # gradient's scale
        scale = top if k == "unnorm_rotations" else np.abs(jgrads[k]).max()
        np.testing.assert_allclose(g.numpy() / scale, jgrads[k] / scale,
                                   atol=5e-5, err_msg=k)


# ---------------------------------------------------------------------------
# P2 and P3 against the tools' kernels in Pallas interpret mode
# ---------------------------------------------------------------------------

VPU_CASES = [(d, op) for d, ops in vpu_probe.CASES for op in ops]


@pytest.mark.parametrize("dname,op", VPU_CASES)
def test_vpu_plain_matches_tool(dname, op):
    tool = _tool("vpu_probe")
    steps, chunk, reps = 2, vpu_probe.CHUNK, 3
    x = np.random.default_rng(4).uniform(0.2, 0.8, (256, steps * chunk))
    x = x.astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dname]
    spec = pl.BlockSpec((256, chunk), lambda c: (0, c))
    call = pl.pallas_call(
        functools.partial(tool._kernel, reps=reps, op=op), grid=(steps,),
        in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((256, steps * chunk), jdt),
        interpret=True)
    ref = np.asarray(jax.jit(call)(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = vpu_probe.ops_plain(torch.tensor(x).to(vpu_probe.DTYPES[dname]), op,
                              reps).float().numpy()
    if dname == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def _assert_scaled(got, ref, rel):
    """Max abs error within ``rel`` of ``ref``'s largest magnitude, with no
    absolute floor."""
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert got.shape == ref.shape and err <= rel * scale, (err, scale)


@pytest.mark.parametrize("case,reps", [(c, 2) for c in ilp_probe.CASES]
                         + [("mxu", 1)])
def test_ilp_plain_matches_tool(case, reps):
    tool = _tool("ilp_probe")
    steps = 2
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(0.2, 0.8, (16, steps * 128)).astype(np.float32)
            for _ in range(2))
    spec = pl.BlockSpec((16, 128), lambda c: (0, c))
    shape = jax.ShapeDtypeStruct((16, steps * 128), jnp.float32)
    call = pl.pallas_call(
        functools.partial(tool._kernel, case=case, reps=reps), grid=(steps,),
        in_specs=[spec, spec], out_specs=[spec, spec],
        out_shape=[shape, shape], interpret=True)
    ra, rb = jax.jit(call)(jnp.asarray(a), jnp.asarray(b))
    ga, gb = ilp_probe.ilp_plain(torch.tensor(a), torch.tensor(b), case, reps)
    # each pass scales by 1e-3: held to the outputs' own scale, so that
    # mxu at reps 1 (one pass) catches a wrong triangle or a lost bf16 term
    _assert_scaled(ga.numpy(), np.asarray(ra), 1e-4)
    _assert_scaled(gb.numpy(), np.asarray(rb), 1e-4)


# ---------------------------------------------------------------------------
# P4 against a numpy evaluation of tools/step_overhead.py's kernel
# ---------------------------------------------------------------------------


def _bf16(a):
    """Round float32 values to bf16 (round to nearest even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _np_step(stream, blk, body, chunk):
    """``make_pf``'s kernel (step_overhead.py:56-96), one grid step at a
    time, Precision.DEFAULT's bf16 operands, sums in float64."""
    tri = np.tril(np.ones((chunk, chunk)))
    acc = np.zeros((256, chunk))
    for c in range(blk.shape[0]):
        win = stream[:, blk[c] * chunk:(blk[c] + 1) * chunk]

        def bcast(r):
            return np.broadcast_to(win[r:r + 1], (256, chunk))

        def dot(v):
            return _bf16(v).astype(np.float64) @ tri

        if body == "passthru":
            acc += bcast(0)
        elif body == "mxu":
            acc += dot(bcast(0))
        elif body == "mxu2dep":
            y = dot(bcast(0)).astype(np.float32)
            acc += dot(y * np.float32(1e-3))
        elif body == "mxu2ind":
            acc += dot(bcast(0)) + dot(bcast(1))
    return acc


@pytest.mark.parametrize("body", step_overhead.BODIES)
def test_step_plain_matches_numpy(body):
    steps = 6
    stream, blk = step_overhead.inputs(steps, "cpu", seed=2)
    assert not np.array_equal(blk.numpy(), np.arange(steps))  # permuted
    got = step_overhead.step(stream, blk, body).numpy()
    ref = _np_step(stream.numpy(), blk.numpy(), body, step_overhead.CHUNK)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5)


# ---------------------------------------------------------------------------
# P1 on a golden scene against JAX's render, preprocess and VJP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ablation_scene(jax_scenes):  # noqa: F811
    """``dense_aniso`` binned (aligned) in the port, with image cotangents
    on RGB and final T; JAX's final T, preprocess and d/dopacity of
    sum(color * Gc) + sum(final_t * Gt) through its jnp render."""
    from splatam_tpu.core.transforms import normalize as jnormalize
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.geometry import preprocess as jpreprocess
    from splatam_tpu.render.render_tiled import rasterize_tiled as jrt

    s = jax_scenes["dense_aniso"]
    a, cam = torch_scene(s)
    w, h = cam.image_width, cam.image_height
    rng = np.random.default_rng(5)
    gc_img = (rng.normal(size=(3, h, w)) * 1e-3).astype(np.float32)
    gt_img = (rng.normal(size=(h, w)) * 1e-3).astype(np.float32)
    jcfg = JCfg(max_instances=2**14, max_per_tile=1024, chunk=128,
                backend="jnp")

    def ref(opac):
        def render(op):
            out, _ = jrt(s["means"], s["colors"], op, s["scales"], s["quats"],
                         s["cam"], cfg=jcfg)
            return out.color, out.final_t

        (_, final_t), vjp = jax.vjp(render, opac)
        (gop,) = vjp((jnp.asarray(gc_img), jnp.asarray(gt_img)))
        p = jpreprocess(s["means"], s["scales"], jnormalize(s["quats"]), s["cam"])
        return final_t, gop, p.means2d, p.conic

    out = [np.asarray(v) for v in jax.jit(ref)(s["opac"])]
    proj = preprocess(torch.tensor(a["means"]), torch.tensor(a["scales"]),
                      torch.tensor(a["quats"]), cam)
    opac = torch.tensor(a["opac"])
    attrs = raster.pack_attrs(proj.means2d, proj.conic, opac, proj.depths,
                              torch.tensor(a["colors"]))
    rgb = image_to_blocks(torch.tensor(gc_img), cam)
    g_color = torch.cat([rgb, rgb.new_zeros((rgb.shape[0], 5, 256))], dim=1)
    return dict(attrs=attrs, cam=cam, opac=a["opac"], g_color=g_color,
                g_t=image_to_blocks(torch.tensor(gt_img)[None], cam)[:, 0],
                final_t=out[0], gop=out[1], means2d=out[2], conic=out[3],
                proj=proj)


def _np_alpha_sum(sc, binned, grid_x):
    """Per-pixel sum of every binned instance's alpha, from JAX's
    preprocess outputs (means2d, conic) and the opacities."""
    ranges = binned.ranges.numpy()
    gid = binned.sorted_gid.numpy()
    p = np.arange(256)
    out = np.zeros((ranges.shape[0], 256))
    for t, (s0, s1) in enumerate(ranges):
        g = gid[s0:s1]
        px = (t % grid_x) * 16 + p % 16
        py = (t // grid_x) * 16 + p // 16
        dx = sc["means2d"][g, 0][:, None] - px[None]
        dy = sc["means2d"][g, 1][:, None] - py[None]
        a, b, c = (sc["conic"][g, i][:, None] for i in range(3))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = np.minimum(0.99, sc["opac"][g][:, None]
                           * np.exp(np.minimum(power, 0.0)))
        out[t] = np.where(alpha < 1 / 255, 0.0, alpha).sum(0)
    return out


@pytest.mark.parametrize("chunk", [64, 256])
def test_ablation_stages_match_jax(ablation_scene, chunk):
    sc = ablation_scene
    cam, attrs = sc["cam"], sc["attrs"]
    binned = bin_gaussians_csr(sc["proj"], cam,
                               RasterConfig(chunk=chunk, layout="aligned"),
                               opacities=torch.tensor(sc["opac"]))
    grid_x = (cam.image_width + 15) // 16
    x = kernel_ablate.ablation_inputs(attrs, binned, grid_x, chunk, nfeat=3)
    g_aux = torch.zeros_like(x.aux)
    g_aux[:, 1] = sc["g_t"]
    x = x._replace(g_color=sc["g_color"], g_aux=g_aux)
    out = {s: kernel_ablate.ablate_plain(s, x) for s in kernel_ablate.STAGES}

    full = out["full"]
    np.testing.assert_array_equal(
        full.numpy(), raster.raster_bwd_plain(
            attrs, binned.sorted_gid, binned.ranges, grid_x, chunk, x.color,
            x.aux, x.g_color, x.g_aux, 3, False).numpy())
    gop = sc["gop"]
    scale = np.abs(gop).max()
    np.testing.assert_allclose(full[:, raster.ROW_OP].numpy() / scale,
                               gop / scale, atol=5e-5)
    # scan: sum of w per pixel is 1 - the final T
    np.testing.assert_allclose(
        blocks_to_image(out["scan"][:, None], cam)[0].numpy(),
        1.0 - sc["final_t"], atol=1e-5, rtol=1e-4)
    # alpha: every instance of the tile's range, nothing dead yet
    np.testing.assert_allclose(out["alpha"].numpy(),
                               _np_alpha_sum(sc, binned, grid_x),
                               atol=1e-5, rtol=1e-4)
    # gc: sum over pixels of dpower = op dL/dop, summed over the gaussians
    ref = float((sc["opac"] * gop).sum())
    tol = 5e-5 * float(np.abs(sc["opac"] * gop).sum())
    assert abs(float(out["gc"].sum()) - ref) <= tol
    # reduce: the block's sums read out per pixel, column p % 16; summed,
    # the moment s0 of the gated d/dopacity plus the part added apart is
    # B2's d/dopacity column, the feature sums its feature columns, and
    # past them all is zero (no median depth, 3 features)
    by_row = out["reduce"].reshape(-1, 16, 16).sum((0, 1))
    for got, ref in ((by_row[0] + by_row[6], full[:, raster.ROW_OP]),
                     *((by_row[raster.ROW_FEAT0 + f],
                        full[:, raster.ROW_FEAT0 + f]) for f in range(3))):
        assert abs(float(got) - float(ref.sum())) <= (
            1e-5 * float(ref.abs().sum()))
    assert not by_row[7].any() and not by_row[raster.ROW_FEAT0 + 3:].any()
    # moments: the warps' mma sums over their own pixels add up to the
    # block's moment and feature columns
    sums = torch.cat([by_row[:6], by_row[raster.ROW_FEAT0:]])
    assert abs(float(out["moments"].sum()) - float(sums.sum())) <= (
        1e-5 * float(out["moments"].abs().sum()))
    # the staging stages see every batch's instances
    assert out["dma0"].eq(1).all()
    assert torch.equal(out["dma_lean"], out["dma_tile"])
    assert (out["dma"] >= out["dma_lean"]).all()


def test_fwd_warp_slots_count_the_plain_forward(ablation_scene):
    """B1's stage probe counts the pairs B1's plain version evaluates, and
    warp slots that hold them, on dense_aniso at chunk 64."""
    sc = ablation_scene
    binned = bin_gaussians_csr(sc["proj"], sc["cam"],
                               RasterConfig(chunk=64, layout="aligned"),
                               opacities=torch.tensor(sc["opac"]))
    gx = (sc["cam"].image_width + 15) // 16
    c = fwd_stages.warp_slots(sc["attrs"], binned, gx, 64)
    _, _, evaluated = raster.raster_fwd_plain(
        sc["attrs"], binned.sorted_gid, binned.ranges, gx, 64, False)
    assert c["pairs"] == int(evaluated.sum()) > 0
    assert 0 < c["faint"] < c["pairs"] <= 32 * c["slots"]
    assert 0 < c["blend"] and c["blend"] + c["none_live"] <= c["slots"]
    length = (binned.ranges[:, 1] - binned.ranges[:, 0]).numpy()
    assert c["range_max"] == length.max()
    np.testing.assert_allclose(c["range_mean"], length.mean(), rtol=1e-6)


def test_probe_wrappers_refuse_cpu_tensors():
    """On a CPU tensor only the dispatchers run the plain versions: the
    kernel wrappers raise, and the entry points need CUDA unless asked."""
    x = torch.zeros((256, 128))
    with pytest.raises(ValueError):
        vpu_probe.ops_cuda(x, "mul_add", 1)
    with pytest.raises(ValueError):
        ilp_probe.ilp_cuda(x[:16], x[:16], "vpu", 1)
    stream, blk = step_overhead.inputs(2, "cpu")
    with pytest.raises(ValueError):
        step_overhead.step_cuda(stream, blk, "mxu")
    binned = Binned(torch.zeros(1, dtype=torch.int32),
                    torch.zeros((1, 2), dtype=torch.int32), None, None, 0)
    with pytest.raises(ValueError):
        fwd_stages.stage_cuda("blend", torch.zeros((1, 16)), binned, 1)
    for run in (vpu_probe.run, ilp_probe.run, step_overhead.run,
                fwd_stages.run):
        with pytest.raises(RuntimeError):
            run()
