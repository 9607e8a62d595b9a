"""Optimizers over dict-of-tensor parameters (port of sparse_vision_tpu/ops/optim.py).

Same structure as the optax transformations the JAX package uses: ``init(params)
-> state`` and ``update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`. The state is a plain dict ``{"mu": {...}, "nu": {...},
"count": int}`` that resample_dead_neurons edits.

Parity targets:
- ConstrainedAdam  utils.py:50-82: project out the gradient component parallel to
  each decoder direction, Adam step with betas (0.9, 0.999), then renormalize the
  directions to unit norm; expressed as the update ``normalize(p + u) - p``.
- get_optimizer    utils.py:84-97: 'adam' with the reference's beta2 = 0.9999.
Both use eps_root = 0 (torch Adam's denominator) and optax's bias correction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _row_norms(w: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(w, dim=-1, keepdim=True)


def project_away_parallel_grad(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """Remove the gradient component parallel to each unit row of ``param``."""
    normed = param / _row_norms(param)
    return grad - (grad * normed).sum(-1, keepdim=True) * normed


def _adam_init(params: dict) -> dict:
    return {
        "mu": {k: torch.zeros_like(v) for k, v in params.items()},
        "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        "count": 0,
    }


def _adam_directions(grads: dict, state: dict, b1: float, b2: float, eps: float):
    """optax.scale_by_adam (eps_root = 0): the bias-corrected direction per leaf."""
    count = state["count"] + 1
    mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
    # bias corrections in f32, as optax computes decay**count
    c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
    dirs = {}
    for k in grads:
        m_hat = mu[k] / c1.to(mu[k].device)
        v_hat = nu[k] / c2.to(nu[k].device)
        dirs[k] = m_hat / (torch.sqrt(v_hat) + eps)
    return dirs, {"mu": mu, "nu": nu, "count": count}


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def update(grads, state, params=None):
        dirs, state = _adam_directions(grads, state, b1, b2, eps)
        return {k: -learning_rate * d for k, d in dirs.items()}, state

    return Optimizer(_adam_init, update)


def sae_constrained_mask(params: dict) -> dict:
    """ConstrainedAdam applies to the decoder weight only (utils.py:96)."""
    return {k: (k == "W_dec") for k in params}


def constrained_adam(learning_rate: float, constrained: Callable = sae_constrained_mask,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam where the leaves selected by ``constrained(params)`` keep unit-norm rows."""

    def update(grads, state, params):
        mask = constrained(params)
        grads = {k: project_away_parallel_grad(g, params[k]) if mask[k] else g
                 for k, g in grads.items()}
        dirs, state = _adam_directions(grads, state, b1, b2, eps)
        updates = {}
        for k, d in dirs.items():
            u = -learning_rate * d
            if mask[k]:
                new_p = params[k] + u
                u = new_p / _row_norms(new_p) - params[k]
            updates[k] = u
        return updates, state

    return Optimizer(_adam_init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: params[k] + updates[k] for k in params}


def get_optimizer(name: str, learning_rate: float) -> Optimizer:
    """Optimizer factory (reference utils.py:84-97), the SAE optimizers of this port."""
    if name == "adam":
        return adam(learning_rate, b1=0.9, b2=0.9999, eps=1e-8)
    if name == "constrained_adam":
        return constrained_adam(learning_rate)
    raise NotImplementedError(
        f"sae_optimizer_name={name!r} is not ported (adam, constrained_adam)")
