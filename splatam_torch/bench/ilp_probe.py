"""P3: do tensor-core passes and FMA chains overlap on the card?

Counterpart of ``tools/ilp_probe.py``. The compositing kernels' work is one
dependent chain of vector math and running sums; on the TPU a running sum
is an MXU pass. This probe times, per block of a ``steps`` grid, a
(256, 128) working set expanded from a (16, 128) window, under five cases:
``vpu`` (an FMA chain), ``mxu`` (tensor-core passes: the two-term bf16
split of x times the upper-triangular 0/1 matrix, summed in f32),
``chain`` (4 FMA ops, a pass, 4 FMA ops, per rep), ``dual`` (two
independent chains) and ``vpu_dual``. dual/chain near 1 means the second
chain hides in the first one's latency; near 2, none does. Kernel
``csrc/probe_ilp.cu`` (``raster.KERNELS["P3"]``: wgmma passes, one
persistent block per SM over the steps' 64-row bands); ``ilp_plain``
beside it.

Usage: python -m splatam_torch.bench.ilp_probe [--steps 2000] [--reps 4]
  [--iters 20] [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from splatam_torch.bench.timing import device_name, time_ms
from splatam_torch.device import resolve_device
from splatam_torch.render import raster

NPIX = 256
CHUNK = 128
ROWS = 16
BAND = 64  # rows of a warpgroup's band in the kernel
CASES = ("vpu", "mxu", "chain", "dual", "vpu_dual")


def _tri(device) -> torch.Tensor:
    i = torch.arange(CHUNK, device=device)
    return (i[:, None] <= i[None, :]).float()  # U[k, n] = 1 for k <= n


def _vpu(x, reps):
    for _ in range(reps):
        x = x * x * -0.5 + 0.6
    return x


def _pass(x, tri):
    x1 = x.bfloat16()
    x2 = (x - x1.float()).bfloat16()
    return x1.float() @ tri + x2.float() @ tri


def _chain(x, tri, reps):
    for _ in range(reps):
        x = _vpu(x, 4)
        x = _pass(x, tri) * 1e-3
        x = _vpu(x, 4)
    return x


def ilp_plain(a: torch.Tensor, b: torch.Tensor, case: str, reps: int):
    """Plain P3 on (16, steps * 128) windows: returns (oa, ob), rows
    [0, 16) of every block's x and y."""
    steps = a.shape[1] // CHUNK
    tri = _tri(a.device)
    ii = torch.arange(NPIX, dtype=torch.float32, device=a.device)[None, :, None]
    x = a[0].reshape(steps, 1, CHUNK) * ii * 1e-3
    y = b[0].reshape(steps, 1, CHUNK) * ii * 1e-3
    if case == "vpu":
        x = _vpu(x, 8 * reps)
    elif case == "mxu":
        for _ in range(reps):
            x = _pass(x, tri) * 1e-3
    elif case == "chain":
        x = _chain(x, tri, reps)
    elif case == "dual":
        x, y = _chain(x, tri, reps), _chain(y, tri, reps)
    elif case == "vpu_dual":
        x, y = _vpu(x, 8 * reps), _vpu(y, 8 * reps)
    else:
        raise ValueError(f"unknown case {case!r}")

    def out(v):
        return v[:, :ROWS].permute(1, 0, 2).reshape(ROWS, steps * CHUNK)

    return out(x), out(y)


def ilp_cuda(a: torch.Tensor, b: torch.Tensor, case: str, reps: int):
    """Launch P3 on (16, steps * 128) f32 windows. Returns (oa, ob)."""
    steps = a.shape[1] // CHUNK
    for name, t in (("a", a), ("b", b)):
        raster._check(t, name, torch.float32, (ROWS, steps * CHUNK))
    oa, ob = torch.empty_like(a), torch.empty_like(b)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    ctas = min(sms, steps * (NPIX // BAND))  # persistent: one block per SM
    raster.ILP_KERNEL.launch(a.device, a.data_ptr(), b.data_ptr(),
                             CASES.index(case), reps, steps, ctas,
                             oa.data_ptr(), ob.data_ptr())
    return oa, ob


def ilp(a, b, case, reps):
    """P3 on CUDA tensors, its plain version on CPU ones."""
    return (ilp_cuda if a.is_cuda else ilp_plain)(a, b, case, reps)


def run(steps=2000, reps=4, iters=20, device=None):
    """Time every case at reps 0 and ``reps``; prints the tool's lines.
    Returns {(case, reps): ms per launch}."""
    dev = resolve_device(device)
    a = torch.full((ROWS, steps * CHUNK), 0.6, device=dev)
    b = torch.full((ROWS, steps * CHUNK), 0.4, device=dev)
    ms = {(c, r): time_ms(lambda: ilp(a, b, c, r), iters, dev)
          for c in CASES for r in (0, reps)}
    ns = {k: v * 1e6 / steps for k, v in ms.items()}
    res = {c: ns[(c, reps)] - ns[(c, 0)] for c in CASES}
    print(f"[ilp] {device_name(dev)}: steps {steps}, per block, reps={reps}; "
          f"compute = t(reps) - t(0)", flush=True)
    for c in CASES:
        print(f"[ilp] {c:9s} base={ns[(c, 0)]:7.1f} ns  full={ns[(c, reps)]:7.1f} "
              f"ns  compute={res[c]:7.1f} ns", flush=True)
    print(f"[ilp] dual/chain: {res['dual'] / res['chain']:.2f} "
          f"(2.0 = no overlap win)", flush=True)
    print(f"[ilp] vpu_dual/vpu: {res['vpu_dual'] / res['vpu']:.2f}", flush=True)
    parts = res["vpu"] + res["mxu"]
    print(f"[ilp] chain vs parts: chain={res['chain']:.0f} vs vpu="
          f"{res['vpu']:.0f} + mxu={res['mxu']:.0f} (sum {parts:.0f}; ratio "
          f"{res['chain'] / parts:.2f})", flush=True)
    print(f"[ilp] vpu ns/(256,128)-op: {res['vpu'] / (8 * reps):.2f}   "
          f"mxu ns/two-term pass: {res['mxu'] / reps:.2f}", flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, args.reps, args.iters, args.device)


if __name__ == "__main__":
    main()
