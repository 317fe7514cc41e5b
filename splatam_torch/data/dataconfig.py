"""Dataset / camera configs (YAML) with ``inherit_from`` recursion.

Counterpart of ``splatam_tpu/data/dataconfig.py``
(`datasets/gradslam_datasets/dataconfig.py:5-54`), read with PyYAML's
``full_load`` as there.
"""
from __future__ import annotations

from typing import Dict, Optional

import yaml


def load_dataset_config(path: str, default_path: Optional[str] = None) -> Dict:
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        cfg = load_dataset_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f)
    else:
        cfg = dict()

    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dict1: Dict, dict2: Dict) -> None:
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
