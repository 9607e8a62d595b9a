"""Backbone factory and layer-dimension probe (port of
sparse_vision_tpu/models/backbone.py).

Every stage declares its output shape, so layer dimensions are a static shape
walk with no forward pass. For a conv tap the SAE input size is the channel
count; for a token tap [N, D] or a linear tap, the width.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.config import NUM_CLASSES, get_img_size
from sparse_vision_tpu_torch.models.cnn import make_cnn1
from sparse_vision_tpu_torch.models.layers import SeqNet
from sparse_vision_tpu_torch.models.mlp import MLP_SPECS, make_mlp, make_mlp9_with_sae
from sparse_vision_tpu_torch.models.vit import CLIP_SPECS, VIT_SPECS

_VITS = tuple(VIT_SPECS) + tuple(CLIP_SPECS)
# every model_name make_backbone builds
BACKBONES = (tuple(MLP_SPECS) + ("custom_mlp_9_sae_fc1", "custom_cnn_1", "inceptionv1",
                                 "googlenet", "resnet50", "resnet18", "resnet18_1",
                                 "resnet18_2")
             + _VITS + tuple(f"{v}_split" for v in _VITS))


def make_backbone(model_name: str, dataset_name: str) -> SeqNet:
    """The SeqNet of ``model_name``; ``net.input_size`` records its input
    convention (ViT/CLIP towers take 224 px on ImageNet, not the 229 px
    InceptionV1 crop)."""
    net = _make_backbone(model_name, dataset_name)
    net.input_size = get_img_size(dataset_name, model_name)
    return net


def _make_backbone(model_name: str, dataset_name: str) -> SeqNet:
    num_classes = NUM_CLASSES[dataset_name]
    if model_name in MLP_SPECS:
        return make_mlp(model_name, num_classes)
    if model_name == "custom_mlp_9_sae_fc1":
        return make_mlp9_with_sae(num_classes)
    if model_name == "custom_cnn_1":
        return make_cnn1(num_classes)
    if model_name in ("inceptionv1", "googlenet"):
        from sparse_vision_tpu_torch.models.googlenet import make_googlenet

        return make_googlenet(num_classes=NUM_CLASSES["imagenet"])
    if model_name == "resnet50":
        from sparse_vision_tpu_torch.models.resnet import make_resnet50

        return make_resnet50(num_classes=NUM_CLASSES["imagenet"])
    # a '_split' suffix splits each encoder block into block{i}_attn / block{i}_mlp
    split_blocks = model_name.endswith("_split")
    vit_name = model_name[:-6] if split_blocks else model_name
    side = get_img_size(dataset_name, model_name)[0]
    if vit_name in VIT_SPECS:
        from sparse_vision_tpu_torch.models.vit import make_vit

        return make_vit(vit_name, num_classes, side, split_blocks=split_blocks)
    if vit_name.startswith("clip_vit"):
        from sparse_vision_tpu_torch.models.vit import make_clip_vision

        if vit_name not in CLIP_SPECS:
            raise ValueError(f"Unknown CLIP spec {vit_name} (available: {sorted(CLIP_SPECS)})")
        return make_clip_vision(vit_name, num_classes, side, split_blocks=split_blocks)
    if model_name in ("resnet18", "resnet18_1", "resnet18_2"):
        from sparse_vision_tpu_torch.models.resnet import make_resnet18

        # resnet18_1 keeps the 224 px stem; resnet18 / resnet18_2 take the
        # Tiny-ImageNet surgery stem
        return make_resnet18(num_classes=num_classes,
                             tiny_imagenet_stem=model_name != "resnet18_1")
    raise ValueError(f"Unsupported model: {model_name}")


def _input_size(net: SeqNet, dataset_name: str) -> tuple:
    return tuple(getattr(net, "input_size", None) or get_img_size(dataset_name))


def init_backbone(net: SeqNet, generator: torch.Generator, dataset_name: str):
    """(params, state) drawn from ``generator``, on its device."""
    return net.init(generator, _input_size(net, dataset_name))


def layer_dimensions(net: SeqNet, dataset_name: str) -> dict:
    """Stage name -> output shape (without the batch dim)."""
    return net.shapes(_input_size(net, dataset_name))


def get_sae_input_size(net: SeqNet, dataset_name: str, sae_layer: str) -> int:
    """Channel count for conv taps, width for token and linear taps."""
    dims = layer_dimensions(net, dataset_name)
    if sae_layer not in dims:
        raise ValueError(f"Layer {sae_layer!r} not in {list(dims)}")
    return int(dims[sae_layer][-1])
