"""Post-SplaTAM map refinement command-line entry point.

Usage: python -m splatam_torch.run.post_opt configs/replica/post_splatam_opt.py
       [--run_name NAME] [--device cpu]

Counterpart of ``splatam_tpu/run/post_opt.py``
(`scripts/post_splatam_opt.py`): start from the SLAM run's ``params.npz``
(``data.param_ckpt_path``), refine the map with the estimated poses held
fixed (``gs/post_opt.post_splatam_opt``), evaluate it, and save
``params.npz`` and ``splat.ply``. Runs on the GPU unless ``--device cpu``
is given. (The JAX CLI's multi-host bootstrap waits for the port's
multi-device slice.)
"""
from __future__ import annotations

import numpy as np

from splatam_torch.device import resolve_device
from splatam_torch.gs.post_opt import post_splatam_opt
from splatam_torch.run.common import (
    build_dataset,
    evaluate_and_save,
    load_experiment_config,
    prepare_results_dir,
    seed_everything,
    standard_argparser,
)


def main(argv=None):
    """Run the CLI on ``argv``. Returns (the final state, the evaluation's
    results)."""
    args = standard_argparser("Post-SplaTAM refinement").parse_args(argv)
    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    results_dir = prepare_results_dir(config, args.config)
    seed_everything(config.get("seed", 0))

    dataset = build_dataset(config)
    ckpt = dict(np.load(config["data"]["param_ckpt_path"], allow_pickle=True))
    state = post_splatam_opt(config, dataset, ckpt, device=dev)
    return state, evaluate_and_save(config, dataset, state, results_dir, dev)


if __name__ == "__main__":
    main()
