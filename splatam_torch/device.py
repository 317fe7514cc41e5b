"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the device a computation runs on.

    ``None`` means ``"cuda"``. When CUDA is absent and the caller did not ask
    for the CPU explicitly, this raises: the port never falls back to the CPU
    on its own. Float32 products stay in full float32 on the card (TF32 off
    for matmuls and for cuDNN convolutions, which the SSIM loss uses).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # tensors report the index they live on
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
