"""Per-layer frozen-SAE registry for circuit discovery (port of
sparse_vision_tpu/interp/registry.py).

One known-good SAE hyperparameter set per GoogLeNet mixed layer, as typed data,
and the checkpoint epoch to load; checkpoints load through train/checkpoint.py
from the directory the port's Pipeline saves a run with those hyperparameters
into.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.device import resolve_device
from sparse_vision_tpu_torch.interp.circuit import FrozenSAE
from sparse_vision_tpu_torch.models.sae import init_sae
from sparse_vision_tpu_torch.train import checkpoint as ckpt
from sparse_vision_tpu_torch.utils.paths import sae_run_name

# GoogLeNet circuit layers (mixed4a is skipped)
CIRCUIT_LAYERS = (
    "mixed3a", "mixed3b", "mixed4b", "mixed4c", "mixed4d", "mixed4e",
    "mixed5a", "mixed5b",
)


@dataclass(frozen=True)
class LayerSAEConfig:
    """Known-good per-layer SAE hyperparameters: batch size 256, lr 1e-3,
    constrained_adam everywhere; only mixed3a differs in expansion factor,
    lambda and dead-neuron schedule."""

    layer: str
    expansion_factor: int
    lambda_sparse: float
    checkpoint_epoch: int
    dead_neurons_steps: int
    learning_rate: float = 1e-3
    batch_size: int = 256
    optimizer: str = "constrained_adam"


LAYER_SAE_CONFIGS: dict = {
    "mixed3a": LayerSAEConfig("mixed3a", 8, 5.0, 7, 626),
    "mixed3b": LayerSAEConfig("mixed3b", 4, 0.1, 6, 625),
    "mixed4a": LayerSAEConfig("mixed4a", 4, 0.1, 6, 625),
    "mixed4b": LayerSAEConfig("mixed4b", 4, 0.1, 6, 625),
    "mixed4c": LayerSAEConfig("mixed4c", 4, 0.1, 5, 625),
    "mixed4d": LayerSAEConfig("mixed4d", 4, 0.1, 7, 625),
    "mixed4e": LayerSAEConfig("mixed4e", 4, 0.1, 9, 625),
    "mixed5a": LayerSAEConfig("mixed5a", 4, 0.1, 5, 625),
    "mixed5b": LayerSAEConfig("mixed5b", 4, 0.1, 12, 625),
}


def registry_config(layer: str, sae_model_name: str = "sae_mlp") -> RunConfig:
    """A RunConfig that trains ``layer``'s SAE with the registry's
    hyperparameters (the defaults elsewhere)."""
    r = LAYER_SAE_CONFIGS[layer]
    return RunConfig(
        sae_layer=layer, sae_model_name=sae_model_name, sae_learning_rate=r.learning_rate,
        sae_batch_size=r.batch_size, sae_optimizer_name=r.optimizer,
        sae_expansion_factor=r.expansion_factor, sae_lambda_sparse=r.lambda_sparse,
        dead_neurons_steps=r.dead_neurons_steps)


def layer_ckpt_dir(checkpoints_root: str, layer: str, sae_model_name: str = "sae_mlp") -> str:
    """The directory where Pipeline saves this layer's SAE when trained with the
    registry hyperparameters (``Pipeline._sae_ckpt_dir``: the run name leaves
    sae_epochs out)."""
    return os.path.join(checkpoints_root, sae_run_name(registry_config(layer, sae_model_name)))


def load_frozen_sae(
    layer: str,
    layer_width: int,
    sae_model_name: str = "sae_mlp",
    checkpoint_dir: Optional[str] = None,
    device=None,
) -> FrozenSAE:
    """The layer's SAE from the registry, initialised from a generator seeded
    with 0 on ``device`` (None means CUDA); with ``checkpoint_dir`` (a
    Pipeline SAE checkpoint directory, see layer_ckpt_dir) the trained
    parameters of the registry's epoch, else of the newest epoch there."""
    r = LAYER_SAE_CONFIGS[layer]
    device = resolve_device(device)
    params = init_sae(sae_model_name, torch.Generator(device=device).manual_seed(0),
                      layer_width, r.expansion_factor)
    if checkpoint_dir is not None:
        epoch = r.checkpoint_epoch
        if not os.path.exists(os.path.join(checkpoint_dir, f"epoch_{epoch}")):
            epoch = ckpt.latest_epoch(checkpoint_dir)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoint epoch under {checkpoint_dir}")
        restored = ckpt.load_checkpoint(checkpoint_dir, epoch)["params"]
        params = {k: v.to(device) for k, v in restored.items()}
    return FrozenSAE(sae_model_name, params, r.expansion_factor)
