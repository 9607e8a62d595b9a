"""Optimizers over dict-of-tensor parameters (port of sparse_vision_tpu/ops/optim.py).

Same structure as the optax transformations the JAX package uses: ``init(params)
-> state`` and ``update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`. Parameters are a dict of tensors, flat (an SAE's) or nested
(a backbone's, one dict per stage). Adam's state is a plain dict ``{"mu": {...},
"nu": {...}, "count": int}`` of the parameters' structure, which
resample_dead_neurons edits.

Parity targets:
- ConstrainedAdam  utils.py:50-82: project out the gradient component parallel to
  each decoder direction, Adam step with betas (0.9, 0.999), then renormalize the
  directions to unit norm; expressed as the update ``normalize(p + u) - p``.
- get_optimizer    utils.py:84-97: 'adam' with the reference's beta2 = 0.9999,
  'sgd' (optax.sgd, no momentum) and 'sgd_w_scheduler' (momentum 0.9 without
  Nesterov, then StepLR: lr * 0.1 ** (epoch // 7), the epoch advanced once per
  train epoch by :func:`advance_epoch`).
Adam uses eps_root = 0 (torch Adam's denominator) and optax's bias correction.

The SAE optimizers (adam, sgd, constrained_adam) also take a learning rate per
combo of a sweep (train/sweep_vmap.py): an [N] tensor, each leaf stacked [N,
...], the rate broadcast over the leaf's other axes (the JAX sweep's traced
per-combo scale). Adam's ``count`` stays one integer: the combos step together.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of a dict tree (and the same leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _row_norms(w: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(w, dim=-1, keepdim=True)


def project_away_parallel_grad(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """Remove the gradient component parallel to each unit row of ``param``."""
    normed = param / _row_norms(param)
    return grad - (grad * normed).sum(-1, keepdim=True) * normed


def _step(learning_rate, d: torch.Tensor) -> torch.Tensor:
    """-learning_rate · d, the rate a float or a per-combo [N] tensor (module
    docstring) broadcast over d's axes after the first."""
    if isinstance(learning_rate, torch.Tensor):
        learning_rate = learning_rate.to(d.device).reshape(-1, *([1] * (d.ndim - 1)))
    return -learning_rate * d


def _adam_init(params: dict) -> dict:
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params), "count": 0}


def _adam_directions(grads: dict, state: dict, b1: float, b2: float, eps: float):
    """optax.scale_by_adam (eps_root = 0): the bias-corrected direction per leaf."""
    count = state["count"] + 1
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
    # bias corrections in f32, as optax computes decay**count
    c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count

    def direction(m, v):
        m_hat = m / c1.to(m.device)
        v_hat = v / c2.to(v.device)
        return m_hat / (torch.sqrt(v_hat) + eps)

    return tree_map(direction, mu, nu), {"mu": mu, "nu": nu, "count": count}


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def update(grads, state, params=None):
        dirs, state = _adam_directions(grads, state, b1, b2, eps)
        return tree_map(lambda d: _step(learning_rate, d), dirs), state

    return Optimizer(_adam_init, update)


def sgd(learning_rate: float) -> Optimizer:
    """optax.sgd without momentum: the update is -lr * g; the state is empty."""

    def update(grads, state, params=None):
        return tree_map(lambda g: _step(learning_rate, g), grads), state

    return Optimizer(lambda params: (), update)


class EpochLRState(NamedTuple):
    inner: dict  # the momentum trace, of the parameters' structure
    epoch: int  # advanced by the pipeline at each epoch's end (advance_epoch)


def sgd_with_step_lr(learning_rate: float, momentum: float = 0.9, step_size: int = 7,
                     gamma: float = 0.1) -> Optimizer:
    """SGD with momentum (optax.trace, no Nesterov: t = g + momentum * t) and a
    per-epoch StepLR (reference utils.py:89-93): the update is ``-lr *
    gamma ** (epoch // step_size) * t``, the scale in f32 as the JAX package
    computes it."""

    def init(params):
        return EpochLRState(inner=tree_map(torch.zeros_like, params), epoch=0)

    def update(grads, state, params=None):
        trace = tree_map(lambda g, t: g + momentum * t, grads, state.inner)
        scale = float(learning_rate * torch.tensor(gamma, dtype=torch.float32) ** (
            state.epoch // step_size))  # an f32 value
        updates = tree_map(lambda t: -scale * t, trace)
        return updates, EpochLRState(inner=trace, epoch=state.epoch)

    return Optimizer(init, update)


def advance_epoch(opt_state):
    """The StepLR epoch counter advanced by one (the reference's per-epoch
    ``scheduler.step()``); any other optimizer's state as it is."""
    if isinstance(opt_state, EpochLRState):
        return opt_state._replace(epoch=opt_state.epoch + 1)
    return opt_state


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
            u = _step(learning_rate, d)
            if mask[k]:
                new_p = params[k] + u
                u = new_p / _row_norms(new_p) - params[k]
            updates[k] = u
        return updates, state

    return Optimizer(_adam_init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: p + u, params, updates)


def get_optimizer(name: str, learning_rate: float) -> Optimizer:
    """Optimizer factory (reference utils.py:84-97)."""
    if name == "adam":
        return adam(learning_rate, b1=0.9, b2=0.9999, eps=1e-8)
    if name == "sgd":
        return sgd(learning_rate)
    if name == "sgd_w_scheduler":
        return sgd_with_step_lr(learning_rate)
    if name == "constrained_adam":
        return constrained_adam(learning_rate)
    raise ValueError(f"Unsupported optimizer: {name}")
