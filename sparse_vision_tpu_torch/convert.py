"""Carry weights and train state from the JAX package's trees, given as numpy
arrays (``jax.device_get`` of them), into the port's tensors, on the CPU.

- SAE params keep the math layout (W_enc [d, h], W_dec [h, d]): a copy each.
- Train state: params, Adam ``mu``/``nu``/``count``, ``step`` and ``dead_acc``;
  a JAX checkpoint tree (Orbax's restore of it) becomes the port's checkpoint
  tree (train/checkpoint.py), so the port can resume a run the JAX package
  started.
- Backbones (every family of models/backbone.py): a weight named ``w`` or
  ``*_w`` goes from the JAX layout to torch's, a conv ``HWIO`` -> ``OIHW`` and
  a linear ``[in, out]`` -> ``[out, in]``; everything else (BatchNorm
  ``scale``/``bias``/``mean``/``var``, LayerNorm scales, biases, the ViT class
  token and position embeddings, the SAE block's ``W_enc``/``W_dec``, which
  keep the math layout) as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def sae_params_from_jax(params: dict) -> dict:
    return {k: _t(v) for k, v in params.items()}


def adam_state_from_jax(mu: dict, nu: dict, count) -> dict:
    """The port's optimizer state from optax ScaleByAdamState fields."""
    return {"mu": sae_params_from_jax(mu), "nu": sae_params_from_jax(nu),
            "count": int(np.asarray(count))}


def train_state_from_jax(ts, seed: int = 0):
    """The port's SAETrainState from a JAX SAETrainState after ``jax.device_get``.
    The Adam state is the optax ScaleByAdamState in ``ts.opt_state`` (alone for
    constrained_adam, first of a chain for adam); the resample generator starts
    from ``seed`` (jax keys do not carry over)."""
    from sparse_vision_tpu_torch.train.steps import SAETrainState

    opt = ts.opt_state
    adam = opt if hasattr(opt, "mu") else next(s for s in opt if hasattr(s, "mu"))
    return SAETrainState(
        params=sae_params_from_jax(ts.params),
        opt_state=adam_state_from_jax(adam.mu, adam.nu, adam.count),
        step=int(np.asarray(ts.step)),
        dead_acc=torch.from_numpy(np.array(ts.dead_acc, dtype=bool)),
        rng=torch.Generator().manual_seed(seed),
    )


def checkpoint_from_jax(tree: dict) -> dict:
    """The port's checkpoint tree from a JAX SAE checkpoint as Orbax restores it
    without a template: numpy leaves; ``opt_state`` the Adam state's fields as a
    dict (constrained_adam), or a list whose first entry is that dict (adam's
    chain)."""
    opt = tree["opt_state"]
    adam = opt if isinstance(opt, dict) else next(
        s for s in opt if isinstance(s, dict) and "mu" in s)
    return {
        "params": sae_params_from_jax(tree["params"]),
        "opt_state": adam_state_from_jax(adam["mu"], adam["nu"], adam["count"]),
        "step": int(np.asarray(tree["step"])),
        "dead_acc": torch.from_numpy(np.array(tree["dead_acc"], dtype=bool)),
    }


def _convert_leaf(path: tuple, a) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    weight = path[-1] == "w" or path[-1].endswith("_w")
    if weight and a.ndim == 4:  # conv HWIO -> OIHW
        return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
    if weight and a.ndim == 2:  # linear [in, out] -> [out, in]
        return torch.from_numpy(np.ascontiguousarray(a.T))
    return _t(a)


def _walk(tree: dict, path: tuple = ()) -> dict:
    return {k: _walk(v, path + (k,)) if isinstance(v, dict) else _convert_leaf(path + (k,), v)
            for k, v in tree.items()}


def backbone_from_jax(params: dict, state: dict) -> tuple:
    """(params, state) of a JAX SeqNet -> the port's SeqNet trees."""
    return _walk(params), _walk(state)
