"""Readings from which a cell's correctness limits are set.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults track_unchanged,map_unchanged] \
        [--seconds 1] [--out FILE]

In one process (the kernels built once), runs the cell on each seed with a
short window and prints one JSON line per run: the program's numbers
(sound runs, the lower readings), with ``--control k`` on the first k
seeds also the precision control's (the reference in bfloat16 in the
program's place), and with ``--faults`` one run per planted fault on each
of the first three seeds (``benchmark/runners`` names the faults). The
benchmark's own runs never run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import guard  # noqa: E402
from benchmark.core.manifest import Cell, load_manifest  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    guard.pin_caches()
    cell = Cell(load_manifest(), args.workload)
    import torch

    dev = guard.require_cards(cell.chips)
    runner = importlib.import_module(
        f"benchmark.runners.{cell.traffic['runner']}")
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    jobs = [(s, None, i < args.control) for i, s in enumerate(seeds)]
    jobs += [(s, f, False) for f in faults for s in seeds[:3]]
    out = open(args.out, "a") if args.out else None
    for seed, fault, control in jobs:
        t0 = time.perf_counter()
        res = runner.run(cell, seed, args.seconds, False, dev, t0, guard.log,
                         fault=fault, control=control)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "checks": res["checks"], "control": res.get("control"),
                "e2e": res["e2e"], "detail": res["detail"],
                "window": res["ctx"]["window"], "check_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
