"""Offline 3DGS training command-line entry point (ground-truth poses).

Usage: python -m splatam_torch.run.gaussian_splatting
       configs/replica/gaussian_splatting.py [--run_name NAME] [--device cpu]

Counterpart of ``splatam_tpu/run/gaussian_splatting.py``
(`scripts/gaussian_splatting.py`): load the experiment config, seed, build
the dataset, train (``gs/offline.offline_splatting``), evaluate the map,
and save ``params.npz`` and ``splat.ply``. Runs on the GPU unless
``--device cpu`` is given. (The JAX CLI's multi-host bootstrap,
``maybe_initialize_distributed``, waits for the port's multi-device slice.)
"""
from __future__ import annotations

from splatam_torch.device import resolve_device
from splatam_torch.gs.offline import offline_splatting
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
    args = standard_argparser("Offline 3DGS training").parse_args(argv)
    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    results_dir = prepare_results_dir(config, args.config)
    seed_everything(config.get("seed", 0))

    dataset = build_dataset(config)
    state = offline_splatting(config, dataset, device=dev)
    return state, evaluate_and_save(config, dataset, state, results_dir, dev)


if __name__ == "__main__":
    main()
