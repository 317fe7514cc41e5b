"""The measures by which a run's outputs are held to the reference.

For optimisation steps (the rule for training runs): each step's
loss as a relative gap; the first gradient's norm per leaf, and the norm of
each leaf's change after the steps, as the gap between the program's norm
and the reference's over the larger of the reference leaf's norm and the
median leaf's, taken at the worst leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's move under Adam by round-off alone
and are left out of the change.
"""
from __future__ import annotations

import statistics

import torch

ROUNDOFF = 1e-3


def loss_gap(prog: list[float], ref: list[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst-leaf gap of the norms of ``prog`` and ``ref`` (dicts of
    tensors), over the leaves in ``keep`` (all where None)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    worst = 0.0
    for k in rn:
        if keep is not None and k not in keep:
            continue
        if k not in pn:
            return float("inf")
        worst = max(worst, abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def moving_leaves(ref_grads: dict) -> set:
    """The leaves whose reference gradient is above round-off."""
    n = _norms(ref_grads)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= ROUNDOFF * med}

