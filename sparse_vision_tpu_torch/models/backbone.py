"""Backbone factory and layer-dimension probe (port of
sparse_vision_tpu/models/backbone.py for the GoogLeNet family).

Every stage declares its output shape, so layer dimensions are a static shape
walk with no forward pass. For a conv tap the SAE input size is the channel count.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.config import NUM_CLASSES, get_img_size
from sparse_vision_tpu_torch.models.layers import SeqNet


def make_backbone(model_name: str, dataset_name: str) -> SeqNet:
    if model_name not in ("inceptionv1", "googlenet"):
        raise NotImplementedError(
            f"model_name={model_name!r} is not ported (inceptionv1, googlenet)")
    from sparse_vision_tpu_torch.models.googlenet import make_googlenet

    net = make_googlenet(num_classes=NUM_CLASSES["imagenet"])
    net.input_size = get_img_size(dataset_name, model_name)
    return net


def _input_size(net: SeqNet, dataset_name: str) -> tuple:
    return tuple(getattr(net, "input_size", None) or get_img_size(dataset_name))


def init_backbone(net: SeqNet, generator: torch.Generator, dataset_name: str):
    """(params, state) drawn from ``generator``, on its device."""
    return net.init(generator, _input_size(net, dataset_name))


def layer_dimensions(net: SeqNet, dataset_name: str) -> dict:
    """Stage name -> output shape (without the batch dim)."""
    return net.shapes(_input_size(net, dataset_name))


def get_sae_input_size(net: SeqNet, dataset_name: str, sae_layer: str) -> int:
    """Channel count for conv taps, width for linear taps."""
    dims = layer_dimensions(net, dataset_name)
    if sae_layer not in dims:
        raise ValueError(f"Layer {sae_layer!r} not in {list(dims)}")
    return int(dims[sae_layer][-1])
