"""Experiment statistics aggregation.

Counterpart of ``splatam_tpu/tools/stats.py`` (`scripts/get_statistics.py`):
collects the metric files every evaluation writes
(``eval/{psnr,ssim,lpips,rmse,l1}.txt``, and under ``eval_nvs`` and
``eval_train``) across experiment directories into one summary table.

Usage: python -m splatam_torch.tools.stats experiments/Replica --out summary.csv
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List

import numpy as np

METRICS = ("psnr", "ssim", "lpips", "rmse", "l1")


def collect_run(run_dir: str) -> Dict[str, float]:
    """{run name, then the nan-mean of each metric file found}."""
    out: Dict[str, float] = {"run": os.path.basename(run_dir.rstrip("/"))}
    for sub in ("eval", "eval_nvs", "eval_train"):
        d = os.path.join(run_dir, sub)
        if not os.path.isdir(d):
            continue
        prefix = "" if sub == "eval" else sub.replace("eval_", "") + "_"
        for m in METRICS:
            for fname in (f"{m}.txt", f"nvs_{m}.txt"):
                path = os.path.join(d, fname)
                if os.path.exists(path):
                    vals = np.loadtxt(path)
                    out[f"{prefix}{m}"] = float(np.nanmean(np.atleast_1d(vals)))
    return out


def aggregate(experiment_dir: str) -> List[Dict[str, float]]:
    """One row per run directory that holds any metric."""
    rows = []
    for run_dir in sorted(glob.glob(os.path.join(experiment_dir, "*"))):
        if os.path.isdir(run_dir):
            row = collect_run(run_dir)
            if len(row) > 1:
                rows.append(row)
    return rows


def write_csv(rows: List[Dict[str, float]], out_path: str) -> None:
    keys = ["run"] + sorted({k for r in rows for k in r} - {"run"})
    with open(out_path, "w") as f:
        f.write(",".join(keys) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description="Summarise experiment metrics")
    p.add_argument("experiment_dir")
    p.add_argument("--out", default="summary.csv")
    args = p.parse_args(argv)
    rows = aggregate(args.experiment_dir)
    if not rows:
        print("No runs with eval results found.")
        return rows
    write_csv(rows, args.out)
    for r in rows:
        print(r)
    print(f"Wrote {args.out} ({len(rows)} runs)")
    return rows


if __name__ == "__main__":
    main()
