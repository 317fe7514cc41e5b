"""The benchmark of splatam_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up runs from the process's start to the window's start (imports, the
card, the sequence made on the card, the kernels built on a checkout's
first run, the cell's set-up frames or steps); the window then runs for
``--seconds`` and closes at the first boundary of a whole frame or step
after that. With ``--trace 1`` the run reports the cell's per-layer
metrics, read by ``benchmark/metrics/<metric>.py`` from the window's
timings and a profiler trace of a few more frames or steps; without, its
end-to-end metrics. After the window the cell's outputs are compared with
the plain reference (``benchmark/reference``); every number compared is
printed beside its limit on the last lines of standard error and under
``checks``, the last key of the result. The last line of standard output is
the result's JSON.
"""
import os
import time

T_START = time.perf_counter()
# one host thread for the numeric libraries' pools (OpenMP, BLAS, torch's
# intra-op pool), fixed before they load: the cells are paced by the host,
# and pools that spread over the shared cores made runs spread wider
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import guard  # noqa: E402
from benchmark.core.manifest import Cell, load_manifest, reader  # noqa: E402
from benchmark.core.trace import top_ops  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(checks: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, none missing, none NaN."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        good = value is not None and not math.isnan(value) and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown


def assemble(cell: Cell, res: dict, trace: bool, device: dict):
    """The result line's dict from a runner's result."""
    ok, shown = judge(res["checks"], cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"])(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": ok, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    summary = res["ctx"].get("trace")
    if trace and summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = {
            "device_ops": [[n[:64], s] for n, s in top_ops(summary)],
            "idle_gaps": [[n[:64], s] for n, s in summary.idle_gaps]}
    out["checks"] = shown
    return out


def main(argv=None):
    args = parse(argv)
    guard.pin_caches()
    manifest = load_manifest()
    cell = Cell(manifest, args.workload)
    import torch

    dev = guard.require_cards(cell.chips)
    runner = importlib.import_module(
        f"benchmark.runners.{cell.traffic['runner']}")
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                     T_START, guard.log)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = assemble(cell, res, bool(args.trace), device)
    found = guard.forbidden_modules()
    if found:
        guard.log(f"[jax] the process holds {found}: no result")
        return 3
    for name, c in out["checks"].items():
        guard.log(f"[check] {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
