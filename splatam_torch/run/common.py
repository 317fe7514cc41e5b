"""Shared driver plumbing: experiment configs, seeding, results directory.

Counterpart of ``splatam_tpu/run/common.py`` (`scripts/splatam.py:1039-1061`):
experiment configs are executable Python modules exposing a ``config``
dict, loaded by path (the files under ``configs/`` load as they are) and
copied into the results directory. Dataset construction waits for the
port's data loaders.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import random
import shutil
from typing import Dict

import numpy as np
import torch


def seed_everything(seed: int = 42) -> None:
    """Seed Python, numpy and torch (`utils/common_utils.py:8-22`)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"Seed: {seed}")


def load_experiment_config(path: str) -> Dict:
    """The ``config`` dict of the experiment file at ``path``."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.config


def prepare_results_dir(config: Dict, config_path: str) -> str:
    """``workdir/run_name``, created, with a copy of the config file."""
    results_dir = os.path.join(config["workdir"], config["run_name"])
    os.makedirs(results_dir, exist_ok=True)
    try:
        shutil.copy(config_path, os.path.join(results_dir, "config.py"))
    except shutil.SameFileError:
        pass
    return results_dir


def standard_argparser(description: str) -> argparse.ArgumentParser:
    """The CLIs' shared flags: the experiment config, ``--run_name`` and
    ``--device`` (cuda unless ``cpu`` is asked for)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("config", type=str, help="Path to experiment config (.py)")
    p.add_argument("--run_name", type=str, default=None,
                   help="Override the experiment's run name")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p
