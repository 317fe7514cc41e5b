"""K-nearest-neighbour search.

Counterpart of ``splatam_tpu/utils/neighbors.py`` (the reference's FAISS
helper, `utils/neighbor_search.py:6-36`): brute-force L2 top-k over query
chunks in the matmul form ||q - p||^2 = ||q||^2 + ||p||^2 - 2 q.p, so the
(Q, N) distance matrix is never held whole. A chunk's matrix is one
``addmm`` into one buffer (||p||^2 - 2 q.p); ||q||^2 is the same along a
row, so it is added to the k values ``topk`` keeps, not to the buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch

# query rows per chunk: a chunk's (CHUNK, N) float32 matrix is 1.67 GB at
# N = 816,000 (every pixel of a 1200x680 frame)
CHUNK = 512


@torch.no_grad()
def knn(
    queries: torch.Tensor,  # (Q, D)
    points: torch.Tensor,  # (N, D)
    k: int = 4,
    chunk: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (squared distances (Q, k), indices (Q, k)) of the k nearest
    points to each query, nearest first."""
    p_sq = (points * points).sum(-1)
    pt = points.t()
    dists, idx = [], []
    for start in range(0, queries.shape[0], chunk):
        qc = queries[start:start + chunk]
        d = torch.addmm(p_sq[None, :], qc, pt, alpha=-2.0)
        val, ind = torch.topk(d, k, dim=-1, largest=False)
        dists.append(torch.clamp(val + (qc * qc).sum(-1, keepdim=True), min=0.0))
        idx.append(ind)
    return torch.cat(dists), torch.cat(idx)


def calculate_neighbors(points: torch.Tensor, k: int = 3,
                        chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-KNN leaving out each point itself (`neighbor_search.py:21-36`)."""
    d, i = knn(points, points, k=k + 1, chunk=chunk)
    return d[:, 1:], i[:, 1:]


def mean_squared_knn_distance(points: torch.Tensor, k: int = 3,
                              chunk: int = CHUNK) -> torch.Tensor:
    """Each point's mean squared distance to its k nearest neighbours, the
    "knn" ``mean_sq_dist_method`` of the Gaussian scale initialisation
    (`scripts/splatam.py:102-112`)."""
    d, _ = calculate_neighbors(points, k=k, chunk=chunk)
    return torch.clamp(d.mean(dim=-1), min=1e-7)
