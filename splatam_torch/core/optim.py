"""Adam with per-parameter learning rates and state surgery.

Counterpart of ``splatam_tpu/core/optim.py``, with torch semantics:

  m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g^2
  p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)

one step count shared by every parameter, eps outside the sqrt (tracking
uses 1e-8, mapping 1e-15). Parameters and moments are updated in place.
The surgery follows the map: appended Gaussians start with zero moments,
pruned ones take theirs away, and a replaced parameter restarts at zero.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    mu: Params
    nu: Params
    step: torch.Tensor  # () float32 on the parameters' device


def init_adam(params: Params) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        step=torch.zeros((), device=dev),
    )


@torch.no_grad()
def adam_step(
    params: Params,
    grads: Params,
    state: AdamState,
    lrs: Dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    apply: torch.Tensor | None = None,
) -> None:
    """One Adam step, in place. ``apply`` (a 0-d bool tensor) leaves the
    parameters, moments and step count as they were where it is false (the
    JAX non-finite-loss guard), without a host sync."""
    t = state.step + 1
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t
    for k, p in params.items():
        g = grads[k]
        m = b1 * state.mu[k] + (1.0 - b1) * g
        v = b2 * state.nu[k] + (1.0 - b2) * g * g
        new_p = p - lrs[k] * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
        if apply is not None:
            m = torch.where(apply, m, state.mu[k])
            v = torch.where(apply, v, state.nu[k])
            new_p = torch.where(apply, new_p, p)
        state.mu[k].copy_(m)
        state.nu[k].copy_(v)
        p.copy_(new_p)
    state.step = t if apply is None else torch.where(apply, t, state.step)


def cat_state_zeros(state: AdamState, keys: Iterable[str], m: int) -> None:
    """The moments grow with the map: ``m`` appended rows start at zero
    (cat_params_to_optimizer parity)."""
    start = next(iter(state.mu.values())).shape[0]
    for k in keys:
        for d in (state.mu, state.nu):
            d[k] = torch.cat([d[k], d[k].new_empty((m,) + d[k].shape[1:])])
    zero_state_slots(state, keys, start, start + m)


def zero_state_slots(state: AdamState, keys: Iterable[str], start: int,
                     stop: int) -> None:
    """Zero the moments of rows [start, stop) for the given keys, in place
    (``splatam_tpu/core/optim.py::zero_state_slots``; the JAX package pads
    the range to its append quantum, which compact tensors do not need)."""
    if stop <= start:
        return
    for k in keys:
        state.mu[k][start:stop] = 0.0
        state.nu[k][start:stop] = 0.0


def prune_state(state: AdamState, keys: Iterable[str], keep: torch.Tensor) -> None:
    """Pruned rows take their moments with them."""
    for k in keys:
        state.mu[k] = state.mu[k][keep]
        state.nu[k] = state.nu[k][keep]


def reset_param_state(state: AdamState, key: str) -> None:
    """Replacing a parameter zeroes its moments."""
    state.mu[key] = torch.zeros_like(state.mu[key])
    state.nu[key] = torch.zeros_like(state.nu[key])
