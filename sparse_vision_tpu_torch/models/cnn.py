"""CustomCNN1 (port of sparse_vision_tpu/models/cnn.py): three conv3x3 (pad 1) ->
ReLU -> maxpool 2 blocks, then fc(512) -> ReLU -> fc(classes). Tapping convN
gives the pre-ReLU conv output, as a hook on the reference's module would."""

from __future__ import annotations

from sparse_vision_tpu_torch.models.layers import SeqNet, conv, flatten, linear, maxpool, relu


def make_cnn1(num_classes: int) -> SeqNet:
    return SeqNet([
        conv("conv1", 32, kernel=3, padding=1), relu("relu1"), maxpool("pool1", 2),
        conv("conv2", 64, kernel=3, padding=1), relu("relu2"), maxpool("pool2", 2),
        conv("conv3", 128, kernel=3, padding=1), relu("relu3"), maxpool("pool3", 2),
        flatten("flatten"),
        linear("fc1", 512), relu("relu_fc1"),
        linear("fc2", num_classes),
    ])
