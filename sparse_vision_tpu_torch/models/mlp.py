"""CustomMLP family (port of sparse_vision_tpu/models/mlp.py): the reference's
ten MLP variants and CustomMLP9 with an SAE spliced after fc1.

Stage names match the reference's module names (fc1, act1, ...); tapping ``fc1``
gives the pre-activation output, as a forward hook on the fc1 module would.
"""

from __future__ import annotations

import math

import torch

from sparse_vision_tpu_torch.models.layers import SeqNet, Stage, flatten, linear, relu, uniform

# hidden widths per variant, and whether ReLUs follow the hidden layers
MLP_SPECS = {
    "custom_mlp_1": ([256, 256], True),
    "custom_mlp_2": ([1024, 512, 256, 128], True),
    "custom_mlp_3": ([64, 32, 16], True),
    "custom_mlp_4": ([32, 16, 16], True),
    "custom_mlp_5": ([10, 10, 10], True),
    "custom_mlp_6": ([64, 32, 5, 16], True),
    "custom_mlp_7": ([32, 16, 16], False),  # as 4, without activations
    "custom_mlp_8": ([32, 16], True),
    "custom_mlp_9": ([16], True),
    "custom_mlp_10": ([10], True),
}


def make_mlp(name: str, num_classes: int = 10) -> SeqNet:
    widths, with_act = MLP_SPECS[name]
    stages = [flatten("flatten")]
    for i, w in enumerate(widths, start=1):
        stages.append(linear(f"fc{i}", w))
        if with_act:
            stages.append(relu(f"act{i}"))
    stages.append(linear(f"fc{len(widths) + 1}", num_classes))
    return SeqNet(stages)


def sae_block(name: str, hidden: int) -> Stage:
    """An SAE as a stage: relu((x - b_dec) @ W_enc + b_enc) @ W_dec + b_dec, its
    code recorded as the sub-tap ``encoded``. Weights in the SAE's math layout
    (W_enc [d, hidden], W_dec [hidden, d]), as models/sae.py keeps them."""

    def init(gen, in_shape):
        (d,) = in_shape
        b1, b2 = 1.0 / math.sqrt(d), 1.0 / math.sqrt(hidden)
        return {"W_enc": uniform(gen, (d, hidden), b1), "b_enc": uniform(gen, (hidden,), b1),
                "W_dec": uniform(gen, (hidden, d), b2), "b_dec": uniform(gen, (d,), b2)}, None

    def apply(params, state, x, train):
        enc = torch.relu((x - params["b_dec"]) @ params["W_enc"] + params["b_enc"])
        return enc @ params["W_dec"] + params["b_dec"], state, {"encoded": enc}

    return Stage(name, init, apply, lambda s: s)


def make_mlp9_with_sae(num_classes: int = 10) -> SeqNet:
    """CustomMLP9 with an SAE baked in after fc1: running custom_mlp_9 with the
    SAE as a splice must equal running this model (the hook-vs-splice check)."""
    return SeqNet([flatten("flatten"), linear("fc1", 16), sae_block("sae_fc1", hidden=16),
                   relu("act1"), linear("fc2", num_classes)])
