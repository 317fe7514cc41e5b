"""LPIPS (AlexNet backbone) in plain PyTorch.

Counterpart of ``splatam_tpu/eval/lpips.py``. The reference uses
`torchmetrics LPIPS(net_type='alex')` (`utils/eval_helpers.py:20-21`); this
module runs the same network (AlexNet features, learned linear heads,
imagenet normalization) with ``F.conv2d``. Pretrained weights are not
bundled: they load from an ``.npz`` at ``SPLATAM_TORCH_LPIPS_WEIGHTS`` (or
an explicit path), which ``convert_torch_lpips`` writes from a
torchvision/lpips checkpoint. Without weights, ``load_lpips`` returns None
and the eval runner reports NaN for LPIPS, as the JAX package does.

npz keys: the convs 'features.{0,3,6,8,10}.weight' / '.bias' (OIHW), the
heads 'lin{0..4}.model.1.weight' (O, I, 1, 1).
"""
from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from splatam_torch.device import resolve_device

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_CONV_KEYS = ["features.0", "features.3", "features.6", "features.8", "features.10"]
_STRIDES = [4, 1, 1, 1, 1]
_PADS = [2, 2, 1, 1, 1]
_POOL_AFTER = {0, 1}  # maxpool after convs 0 and 1 (and relu after each)


def lpips_forward(weights: Dict[str, torch.Tensor], img1: torch.Tensor,
                  img2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between (C, H, W) images in [0, 1]."""
    dev, dt = img1.device, img1.dtype
    shift = torch.as_tensor(_SHIFT, device=dev, dtype=dt)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=dev, dtype=dt)[:, None, None]

    def features(x):
        x = ((2.0 * x - 1.0) - shift) / scale  # normalize=True convention
        x = x[None]
        feats = []
        for i, key in enumerate(_CONV_KEYS):
            x = F.conv2d(x, weights[f"{key}.weight"], weights[f"{key}.bias"],
                         stride=_STRIDES[i], padding=_PADS[i])
            x = F.relu(x)
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    total = 0.0
    for i, (a, b) in enumerate(zip(features(img1), features(img2))):
        a = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + 1e-10)
        lin = weights[f"lin{i}.model.1.weight"][:, :, 0, 0]  # (1, C)
        total = total + torch.mean(
            torch.einsum("nchw,oc->nohw", (a - b) ** 2, lin), dim=(1, 2, 3)
        )
    return total[0]


def load_lpips(path: Optional[str] = None, device=None) -> Optional[Callable]:
    """lpips(img1, img2) -> scalar with the weights at ``path`` on
    ``device`` (None means CUDA), or None without weights."""
    path = path or os.environ.get("SPLATAM_TORCH_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    dev = resolve_device(device)
    weights = {k: torch.as_tensor(v, device=dev)
               for k, v in dict(np.load(path)).items()}

    @torch.no_grad()
    def lpips(a, b):
        return lpips_forward(weights, a, b)

    return lpips


def convert_torch_lpips(torch_lpips_state: Dict, out_path: str):
    """Convert a torchmetrics/lpips state_dict into the npz this module reads.

    The lpips package stores the AlexNet convs under `net.sliceK.<idx>` where
    <idx> is the ORIGINAL torchvision features index (0/3/6/8/10) — the
    slice number is packaging, not an index — and the learned heads under
    `lin{i}.model.1.weight` (torchmetrics prefixes everything with one more
    `net.`).
    """
    out = {}
    for k, v in torch_lpips_state.items():
        arr = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        m = re.search(r"slice\d+\.(\d+)\.(weight|bias)$", k)
        if m:
            out[f"features.{m.group(1)}.{m.group(2)}"] = arr
            continue
        m = re.search(r"(lin\d+\.model\.1\.weight)$", k)
        if m:
            out[m.group(1)] = arr
    expected = {f"{c}.{s}" for c in _CONV_KEYS for s in ("weight", "bias")}
    expected |= {f"lin{i}.model.1.weight" for i in range(5)}
    missing = expected - set(out)
    if missing:
        raise ValueError(f"state dict missing expected LPIPS keys: {missing}")
    np.savez(out_path, **out)
