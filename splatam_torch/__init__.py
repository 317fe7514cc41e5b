"""splatam-torch: the SplaTAM SLAM port to PyTorch and hand-written CUDA.

The JAX package ``splatam_tpu`` beside it is the reference this package is
held against (``tests/test_torch_*.py``). Module names mirror it, so each
counterpart is found under the same path. Entry points run on the GPU unless
the caller passes ``device="cpu"``; see ``splatam_torch.device``.
"""

__version__ = "0.1.0"
