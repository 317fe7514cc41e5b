"""The measurement path: the benchmark and the probes of the kernels.

Counterpart of ``bench.py`` and of the probes in ``tools/``:

- ``scene``: the measured program (``bench.py::setup``): a SplaTAM mapping
  iteration on 200k gaussians at 1200x680, chained;
- ``__main__``: ``python -m splatam_torch.bench [mode]``, one JSON line of
  ``rasterizer_fwd_bwd_throughput`` (``bench.py::main``);
- ``profile``: the top device ops of one run (``tools/profile_bench.py``);
- ``kernel_ablate`` (P1, ``csrc/probe_ablate.cu``): B2 stage by stage;
- ``vpu_probe`` (P2, ``csrc/probe_ops.cu``): elementwise op rates;
- ``ilp_probe`` (P3, ``csrc/probe_ilp.cu``): tensor-core / FMA overlap;
- ``step_overhead`` (P4, ``csrc/probe_step.cu``): the fixed cost per block.

Each probe kernel is built by ``render.raster.build_kernels`` and counted in
``render.raster.KERNELS``; on a CPU tensor its wrapper runs the plain
version beside it.
"""
