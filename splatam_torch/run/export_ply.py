"""PLY export command-line entry point.

Usage: python -m splatam_torch.run.export_ply configs/replica/splatam.py
       [--run_name NAME] [--device cpu]

Counterpart of ``splatam_tpu/run/export_ply.py`` (`scripts/export_ply.py`):
reads the run's ``params.npz`` and writes its Gaussians as ``splat.ply``
(the Inria 3DGS layout) beside it. Loads the map on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import os

from splatam_torch.device import resolve_device
from splatam_torch.run.common import load_experiment_config, standard_argparser
from splatam_torch.utils.checkpoint import load_params
from splatam_torch.utils.ply import save_ply_from_params


def main(argv=None) -> str:
    """Run the CLI on ``argv``; returns the PLY's path."""
    args = standard_argparser("Export splat PLY").parse_args(argv)
    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    run_dir = os.path.join(config["workdir"], config["run_name"])
    params, _, _ = load_params(os.path.join(run_dir, "params.npz"), device=dev)
    path = os.path.join(run_dir, "splat.ply")
    save_ply_from_params(path, params)
    return path


if __name__ == "__main__":
    main()
