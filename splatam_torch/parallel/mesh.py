"""Rank grids and process-group bootstrap.

Counterpart of ``splatam_tpu/parallel/mesh.py``. Two axes as there:

  * ``tiles``: image-tile parallelism for the render: each rank composites
    a band of tile rows (and columns, on a 2-D grid) against a replicated
    view of the Gaussians; the gradients of the replicated inputs are
    all-reduced over the axis.
  * ``data``: keyframe-batch parallelism for refinement: one all-reduce of
    the parameter gradients per step.

JAX places arrays on a device mesh (``NamedSharding``) and lets SPMD insert
the collectives. Here each rank is one process; a ``Mesh`` holds the rank
grid, this rank's coordinates and one ``torch.distributed`` group per set of
axes, and the parallel modules call the collectives on those groups.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from splatam_torch.device import resolve_device


def maybe_initialize_distributed(device=None) -> bool:
    """Env-gated process-group bootstrap.

    Reads torchrun's ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``, or the JAX package's ``SPLATAM_TPU_COORDINATOR``
    (or ``JAX_COORDINATOR_ADDRESS``, host:port) with
    ``SPLATAM_TPU_NUM_PROCESSES`` / ``SPLATAM_TPU_PROCESS_ID`` as the world
    size and rank. Joins with ``nccl`` when ``device`` is CUDA (None means
    CUDA, and raises without it) and ``gloo`` on the CPU. Returns True if a
    process group is up, False (doing nothing) when none of the variables
    is set. The CLIs call it first, as the JAX CLIs do.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    coord = (os.environ.get("SPLATAM_TPU_COORDINATOR")
             or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not coord and "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and device is None and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coord:
        world = int(os.environ.get("SPLATAM_TPU_NUM_PROCESSES",
                                   os.environ.get("WORLD_SIZE", 1)))
        rank = int(os.environ.get("SPLATAM_TPU_PROCESS_ID",
                                  os.environ.get("RANK", 0)))
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=world, rank=rank)
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


class Mesh:
    """A grid of ranks over named axes, laid out row-major in the order
    ``shape`` names them (``{"data": 2, "tiles": 4}``: rank r sits at
    data r // 4, tiles r % 4).

    ``shape[axis]`` is the axis size and ``index(axis)`` this rank's
    coordinate on it. ``group(*axes)`` is the process group of the ranks
    that share this rank's coordinates on every other axis, its ranks in
    row-major order over ``axes``; ``group_rank_coords(*axes)`` lists their
    coordinates in that order. Every group is created when the mesh is,
    by every rank of ``group`` (or of the world), as ``new_group`` asks.
    Without an initialised process group only a one-rank mesh exists, and
    its groups are None: no collective runs. With one, the groups exist
    whatever their size (at world size 1 the collectives run on one rank).
    """

    def __init__(self, shape: Dict[str, int], group=None):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape: Dict[str, int] = {k: int(v) for k, v in shape.items()}
        size = math.prod(self.shape.values())
        distributed = dist.is_available() and dist.is_initialized()
        if distributed:
            ranks = (dist.get_process_group_ranks(group) if group is not None
                     else list(range(dist.get_world_size())))
            me = dist.get_rank()
        else:
            ranks, me = [0], 0
        if size != len(ranks):
            raise ValueError(
                f"mesh {'x'.join(map(str, self.shape.values()))} != "
                f"{len(ranks)} ranks")
        self.ranks = ranks
        dims = tuple(self.shape.values())
        self._coords = dict(zip(ranks, itertools.product(
            *(range(d) for d in dims))))
        self.coords = dict(zip(self.axis_names, self._coords[me]))
        self._groups = {}
        if not distributed:
            return
        # one group per (set of axes, coordinates on the other axes): all
        # ranks create all of them, in the same order
        for r in range(1, len(dims) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                rest = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    members = [g for g in ranks if all(
                        self._coord(g, a) == v for a, v in zip(rest, fixed))]
                    pg = dist.new_group(members)
                    if me in members:
                        self._groups[axes] = pg

    def _coord(self, rank: int, axis: str) -> int:
        return self._coords[rank][self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, *axes: str):
        return self._groups.get(tuple(a for a in self.axis_names if a in axes))

    def group_rank_coords(self, *axes: str) -> list:
        """Coordinates on ``axes`` of the members of ``group(*axes)``, in
        group-rank order."""
        axes = tuple(a for a in self.axis_names if a in axes)
        return list(itertools.product(*(range(self.shape[a]) for a in axes)))


def make_mesh(n_tiles: Optional[int] = None, n_data: int = 1,
              group=None) -> Mesh:
    """A (data, tiles) mesh over the ranks of ``group`` (None: the world;
    without a process group, the 1x1 mesh)."""
    world = (dist.get_world_size(group) if dist.is_available()
             and dist.is_initialized() else 1)
    if n_tiles is None:
        n_tiles = world // n_data
    if n_data * n_tiles != world:
        raise ValueError(f"mesh {n_data}x{n_tiles} != {world} ranks")
    return Mesh({"data": n_data, "tiles": n_tiles}, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0, in group-rank order."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` summed, then this rank's 1/n of the rows."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, x.contiguous(), group=group)
    return out
