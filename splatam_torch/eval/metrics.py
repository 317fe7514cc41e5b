"""Image-quality metrics: PSNR (reference parity), SSIM, MS-SSIM.

Counterpart of ``splatam_tpu/eval/metrics.py``:

  * psnr: per-channel MSE -> 20 log10(1/sqrt(mse)), averaged over channels
    (`utils/slam_external.py:49-51`).
  * ms_ssim: Wang et al. 5-scale MS-SSIM, 11x11 Gaussian window sigma 1.5,
    VALID padding, 2x average-pool downsampling, standard weights,
    relu-clamped cs terms (pytorch_msssim-compatible); fewer scales, with
    the weights renormalized, on images too small for five.

The filters are depthwise ``F.conv2d``; ``resolve_device`` keeps cuDNN out
of TF32 on the card.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(C, H, W) pair -> scalar; per-channel PSNR averaged."""
    c = img1.shape[0]
    mse = ((img1 - img2).reshape(c, -1) ** 2).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()


@functools.lru_cache(maxsize=None)
def _gauss_1d(size: int, sigma: float, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 1-D SSIM window, built once per (size, sigma, device, dtype):
    each build is a host-to-device copy."""
    g = torch.tensor(
        [math.exp(-((x - size // 2) ** 2) / (2 * sigma**2)) for x in range(size)],
        dtype=dtype, device=device,
    )
    return g / g.sum()


@functools.lru_cache(maxsize=None)
def _scale_weights(weights: tuple, usable: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """MS-SSIM's first ``usable`` scale weights, renormalized (cached)."""
    w = torch.tensor(weights[:usable], dtype=dtype, device=device)
    return w / w.sum()


def _filter_valid(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID separable filter of (C, H, W) by the 1-D window g."""
    c, k = x.shape[0], g.shape[0]
    y = F.conv2d(x[None], g.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(y, g.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)[0]


def _ssim_maps(img1, img2, g, data_range=1.0, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _filter_valid(img1, g)
    mu2 = _filter_valid(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter_valid(img1 * img1, g) - mu1_sq
    sigma2_sq = _filter_valid(img2 * img2, g) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, g) - mu1_mu2
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    return ssim_map, cs


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Single-scale SSIM over (C, H, W), VALID padding."""
    s, _ = _ssim_maps(img1, img2, _gauss_1d(11, 1.5, img1.device, img1.dtype),
                      data_range)
    return s.mean()


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, zero-padding an odd edge at the end."""
    x = F.pad(x, (0, x.shape[2] % 2, 0, x.shape[1] % 2))
    return F.avg_pool2d(x[None], 2)[0]


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
            weights=MS_SSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM over (C, H, W); all five scales need
    min(H, W) > 160."""
    g = _gauss_1d(11, 1.5, img1.device, img1.dtype)
    min_dim = min(img1.shape[1], img1.shape[2])
    usable = max(1, min(len(weights), int(math.log2(max(min_dim // 11, 1))) + 1))
    w = _scale_weights(tuple(weights), usable, img1.device, img1.dtype)
    terms = []
    x, y = img1, img2
    for i in range(usable):
        s, cs = _ssim_maps(x, y, g, data_range)
        if i < usable - 1:
            terms.append(torch.relu(cs.mean()))
            x, y = _avg_pool2(x), _avg_pool2(y)
        else:
            terms.append(torch.relu(s.mean()))
    return torch.prod(torch.stack(terms) ** w)
