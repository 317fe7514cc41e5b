"""P3 and P4 against an earlier checkout's designs on the card, alternated.

Builds ``<parent>/splatam_torch/render/csrc/probe_step.cu`` and
``probe_ilp.cu`` with this checkout's nvcc flags, each in one translation
unit with an occupancy entry, and compares them with this checkout's
kernels on the same inputs: registers and blocks per SM (the CUDA
runtime), tensor-core instructions per kernel (``cuobjdump -sass``), every
output of both designs against the plain version (1e-4 of scale), and the
times, each (P4 body, P3 case and reps) timed in turns parent, new, new,
parent per round with CUDA events. Prints a table per probe and one JSON
line with every number.

Usage: python -m splatam_torch.bench.probe_ab --parent build/parent
  [--rounds 3] [--iters 20] [--p4_steps 8000] [--p3_steps 2000]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from pathlib import Path

import torch

from splatam_torch.bench import ilp_probe, step_overhead
from splatam_torch.bench.timing import device_name, time_ms
from splatam_torch.device import resolve_device
from splatam_torch.render import raster

TOL = 1e-4  # of each output's largest magnitude, as chip_smoke.py holds them
P3_REPS = 4
# the parent's kernel templates by index (its Body / Case enums)
SHIM = {
    "probe_step": ("step_kernel", len(step_overhead.BODIES), 256),
    "probe_ilp": ("ilp_kernel", len(ilp_probe.CASES), 256),
}


def _shim_source(parent_cu: Path, source: str) -> str:
    kernel, n, threads = SHIM[source]
    cases = "".join(f"    case {i}: k = (const void*){kernel}<{i}>; break;\n"
                    for i in range(n))
    return (f'#include "{parent_cu}"\n'
            f'extern "C" int parent_occupancy(int i, int* regs, int* blocks) {{\n'
            f"  const void* k = nullptr;\n  switch (i) {{\n{cases}"
            f"    default: return (int)cudaErrorInvalidValue;\n  }}\n"
            f"  cudaFuncAttributes a;\n"
            f"  cudaError_t rc = cudaFuncGetAttributes(&a, k);\n"
            f"  if (rc != cudaSuccess) return (int)rc;\n"
            f"  *regs = a.numRegs;\n"
            f"  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor("
            f"blocks, k, {threads}, 0);\n}}\n")


def build_parent(parent: Path) -> dict:
    """Compile the parent's two probe sources (with the occupancy shim) into
    build/kernels/; returns {source: library path}. Prints ptxas's log."""
    raster.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in SHIM:
        cu = (parent / "splatam_torch/render/csrc" / f"{source}.cu").resolve()
        shim = raster.BUILD_DIR / f"parent_{source}.cu"
        shim.write_text(_shim_source(cu, source))
        lib = raster.BUILD_DIR / f"libparent_{source}.so"
        cmd = [raster._nvcc(), *raster.NVCC_FLAGS, "-o", str(lib), str(shim)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         lib)
    libs = {}
    for source, (proc, lib) in procs.items():
        text = proc.communicate()[0]
        print(f"== nvcc parent {source}\n{text.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {source}")
        libs[source] = lib
    return libs


def _tag(fn: str, kernel: str):
    """The template index of a mangled ``kernel<i>`` name, else None."""
    key = f"{kernel}ILi"
    if key not in fn:
        return None
    return int(fn.split(key)[1].split("E")[0])


def occupancy(parent_libs: dict) -> dict:
    """{(source, index): {"parent": (regs, blocks), "new": (regs, blocks)}}."""
    ptr = ctypes.POINTER(ctypes.c_int)
    out = {}
    for source, (_, n, _) in SHIM.items():
        lib = ctypes.CDLL(str(parent_libs[source]))
        fn = lib.parent_occupancy
        fn.argtypes = [ctypes.c_int, ptr, ptr]
        kernel = raster.KERNELS["P4" if source == "probe_step" else "P3"]
        for i in range(n):
            regs, blocks = ctypes.c_int(), ctypes.c_int()
            rc = fn(i, ctypes.byref(regs), ctypes.byref(blocks))
            if rc != 0:
                raise RuntimeError(f"parent {source} occupancy: CUDA error {rc}")
            out[(source, i)] = {"parent": (regs.value, blocks.value),
                                "new": kernel.occupancy(i)}
    return out


class Parent:
    """The parent's C entries, called on this checkout's tensors."""

    def __init__(self, libs):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.step = ctypes.CDLL(str(libs["probe_step"])).probe_step
        self.step.argtypes = [vp, vp, ci, ci, vp, vp]
        self.ilp = ctypes.CDLL(str(libs["probe_ilp"])).probe_ilp
        self.ilp.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        for fn in (self.step, self.ilp):
            fn.restype = ci

    @staticmethod
    def _stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def step_call(self, stream, blk, body):
        out = torch.zeros((step_overhead.NPIX, step_overhead.CHUNK),
                          device=stream.device)
        rc = self.step(stream.data_ptr(), blk.data_ptr(),
                       step_overhead.BODIES.index(body), blk.shape[0],
                       out.data_ptr(), self._stream(stream))
        if rc != 0:
            raise RuntimeError(f"parent probe_step: CUDA error {rc}")
        return out

    def ilp_call(self, a, b, case, reps):
        oa, ob = torch.empty_like(a), torch.empty_like(b)
        rc = self.ilp(a.data_ptr(), b.data_ptr(), ilp_probe.CASES.index(case),
                      reps, a.shape[1] // ilp_probe.CHUNK, oa.data_ptr(),
                      ob.data_ptr(), self._stream(a))
        if rc != 0:
            raise RuntimeError(f"parent probe_ilp: CUDA error {rc}")
        return oa, ob


def _err(got, ref):
    """(max abs error, largest magnitude of the reference)."""
    return (float((got - ref).abs().max()), float(ref.abs().max()))


def _alternate(fns: dict, rounds: int, iters: int, dev) -> dict:
    """{name: [ms ...]}: rounds of parent, new, new, parent."""
    ms = {k: [] for k in fns}
    for _ in range(rounds):
        for k in ("parent", "new", "new", "parent"):
            ms[k].append(time_ms(fns[k], iters, dev))
    return ms


def p4_kernel_split(stream, blk, calls=10) -> dict:
    """{body: {kernel name: device us per call}} of the new P4's two
    kernels, from ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for body in step_overhead.BODIES:
        step_overhead.step_cuda(stream, blk, body)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                step_overhead.step_cuda(stream, blk, body)
            torch.cuda.synchronize()
        out[body] = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0)
            for name in ("step_kernel", "step_sum"):
                if name in e.key and us > 0:
                    out[body][name] = us / e.count
        print(f"[ab] P4 {body:9s} device time per call: " + ", ".join(
            f"{k} {v:.1f} us" for k, v in out[body].items()), flush=True)
    return out


def run(parent, rounds=3, iters=20, p4_steps=8000, p3_steps=2000,
        device=None):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_ab times kernels: it needs the card")
    libs = build_parent(Path(parent))
    logs = raster.build_kernels(("probe_step", "probe_ilp"))
    for name, text in logs.items():
        print(f"== nvcc {name}\n{text.strip()}", flush=True)
    par = Parent(libs)
    print(f"[ab] {device_name(dev)}; parent {parent}", flush=True)

    occ = occupancy(libs)
    sass = {}
    for source, (kernel, n, _) in SHIM.items():
        for design, lib in (("parent", libs[source]),
                            ("new", raster._library_path(source))):
            for fn, c in raster.sass_mma_counts(lib).items():
                i = _tag(fn, kernel)
                if i is not None:
                    sass[(source, i, design)] = (c["HMMA"], c["HGMMA"],
                                                 c["DEPBAR"])
    names = {"probe_step": step_overhead.BODIES, "probe_ilp": ilp_probe.CASES}
    for (source, i), o in occ.items():
        sp, sn = sass.get((source, i, "parent")), sass.get((source, i, "new"))
        print(f"[ab] {source} {names[source][i]:9s} parent: {o['parent'][0]} "
              f"registers, {o['parent'][1]} blocks/SM, HMMA/HGMMA {sp}; new: "
              f"{o['new'][0]} registers, {o['new'][1]} blocks/SM, HMMA/HGMMA "
              f"{sn}", flush=True)

    failed = []
    result = {"device": device_name(dev), "p4": {}, "p3": {}}
    # P4: every body, both designs against the plain version, then timed
    stream, blk = step_overhead.inputs(p4_steps, dev)
    for body in step_overhead.BODIES:
        ref = step_overhead.step_plain(stream, blk, body)
        fns = {"parent": lambda b=body: par.step_call(stream, blk, b),
               "new": lambda b=body: step_overhead.step_cuda(stream, blk, b)}
        errs = {}
        for k, fn in fns.items():
            err, scale = _err(fn(), ref)
            errs[k] = err
            if err > TOL * scale and err > 0:
                failed.append(f"P4 {body} {k}: {err:.3g} of {scale:.3g}")
        ms = _alternate(fns, rounds, iters, dev)
        result["p4"][body] = {"ms": ms, "err": errs, "scale": scale}
        print(f"[ab] P4 {body:9s} parent {min(ms['parent']):.4f} ms (mean "
              f"{sum(ms['parent']) / len(ms['parent']):.4f}), new "
              f"{min(ms['new']):.4f} ms (mean "
              f"{sum(ms['new']) / len(ms['new']):.4f}); max err parent "
              f"{errs['parent']:.3g}, new {errs['new']:.3g} of {scale:.3g}",
              flush=True)
    result["p4"]["kernels_us"] = p4_kernel_split(stream, blk)
    gather = time_ms(lambda: stream.view(step_overhead.ROWS, p4_steps,
                                         step_overhead.CHUNK)[:, blk.long()],
                     iters, dev)
    result["p4"]["gather_ms"] = gather
    print(f"[ab] P4 yardstick: one PyTorch gather of the {p4_steps} windows "
          f"(the same reads, and as many bytes written) {gather:.4f} ms",
          flush=True)
    del stream, blk
    torch.cuda.empty_cache()

    # P3: every case at reps 0 and P3_REPS, checked on random windows, timed
    # on the tool's constant ones
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (ilp_probe.ROWS, p3_steps * ilp_probe.CHUNK)
    ra, rb = (torch.rand(shape, generator=gen, device=dev) for _ in range(2))
    ta = torch.full(shape, 0.6, device=dev)
    tb = torch.full(shape, 0.4, device=dev)
    for case in ilp_probe.CASES:
        for reps in (0, 1, P3_REPS):
            refs = ilp_probe.ilp_plain(ra, rb, case, reps)
            errs = {}
            for k, fn in (("parent", par.ilp_call), ("new", ilp_probe.ilp_cuda)):
                got = fn(ra, rb, case, reps)
                e = [_err(g, r) for g, r in zip(got, refs)]
                errs[k] = [x for x, _ in e]
                for tag, (err, scale) in zip("ab", e):
                    if err > TOL * scale and err > 0:
                        failed.append(f"P3 {case} {reps} {tag} {k}: {err:.3g} "
                                      f"of {scale:.3g}")
            if reps == 1:
                continue
            fns = {"parent": lambda c=case, r=reps: par.ilp_call(ta, tb, c, r),
                   "new": lambda c=case, r=reps: ilp_probe.ilp_cuda(ta, tb, c, r)}
            ms = _alternate(fns, rounds, iters, dev)
            result["p3"][f"{case}/{reps}"] = {"ms": ms, "err": errs}
            print(f"[ab] P3 {case:9s} reps {reps}: parent "
                  f"{min(ms['parent']):.4f} ms, new {min(ms['new']):.4f} ms; "
                  f"max err parent {max(errs['parent']):.3g}, new "
                  f"{max(errs['new']):.3g}", flush=True)
    for design in ("parent", "new"):
        ns = {c: (min(result["p3"][f"{c}/{P3_REPS}"]["ms"][design])
                  - min(result["p3"][f"{c}/0"]["ms"][design])) * 1e6 / p3_steps
              for c in ilp_probe.CASES}
        result["p3"][f"compute_ns_{design}"] = ns
        print(f"[ab] P3 {design}: compute ns per step "
              + ", ".join(f"{c} {v:.1f}" for c, v in ns.items())
              + f"; dual/chain {ns['dual'] / ns['chain']:.2f}, vpu_dual/vpu "
              f"{ns['vpu_dual'] / ns['vpu']:.2f}", flush=True)
    print(json.dumps({"probe_ab": result}, default=str), flush=True)
    if failed:
        raise RuntimeError("outputs off their plain versions: "
                           + "; ".join(failed))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the earlier design (git archive)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--p4_steps", type=int, default=8000)
    ap.add_argument("--p3_steps", type=int, default=2000)
    ap.add_argument("--device", default=None, help="cuda (the default)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.parent):
        ap.error(f"--parent {args.parent} is not a directory")
    return run(args.parent, args.rounds, args.iters, args.p4_steps,
               args.p3_steps, args.device)


if __name__ == "__main__":
    main()
