"""Multi-device rendering and training on ``torch.distributed``.

Counterpart of ``splatam_tpu/parallel/``: a rank grid with one process
group per axis (``mesh``), image tile bands rendered per rank and gathered
(``pallas_sharded``), keyframe-batch data parallelism (``sharded``) and
Gaussian-primitive sharding with compact record gathers (``prim_sharded``).
"""
