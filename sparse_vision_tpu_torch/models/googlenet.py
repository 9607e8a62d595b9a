"""GoogLeNet / InceptionV1 as a SeqNet (port of sparse_vision_tpu/models/googlenet.py
without the aux heads).

Matches torchvision's GoogLeNet: BasicConv2d = bias-free conv + BatchNorm(eps=1e-3)
+ ReLU; the inception "5x5" branch uses a 3x3 kernel; every maxpool is ceil_mode;
the pool branch pads with -inf. Stage names follow the ``mixed*`` convention.
Inputs are NHWC; at 229 px ``mixed3a`` is 28 x 28 x 256.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sparse_vision_tpu_torch.models.layers import (
    SeqNet,
    Stage,
    fn_stage,
    global_avgpool,
    linear,
    maxpool,
    uniform,
)

_BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm2d(eps=0.001)


def _bc_init(gen: torch.Generator, cin: int, cout: int, k: int):
    w = uniform(gen, (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k))
    dev = gen.device
    params = {"w": w, "scale": torch.ones(cout, device=dev), "bias": torch.zeros(cout, device=dev)}
    state = {"mean": torch.zeros(cout, device=dev), "var": torch.ones(cout, device=dev)}
    return params, state


def _bc_apply(p: dict, s: dict, x: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    y = F.conv2d(x, p["w"], stride=stride, padding=pad)
    y = F.batch_norm(y, s["mean"], s["var"], p["scale"], p["bias"], training=False, eps=_BN_EPS)
    return torch.relu(y)


def basic_conv_stage(name: str, cout: int, k: int, stride: int = 1, pad: int = 0) -> Stage:
    def out_shape(s):
        h, w, _ = s
        return ((h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1, cout)

    return Stage(name, lambda gen, s: _bc_init(gen, s[-1], cout, k),
                 lambda p, st, x: _bc_apply(p, st, x, stride, pad), out_shape)


# (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) per block: torchvision's
# constructor arguments; output channels = ch1x1 + ch3x3 + ch5x5 + pool_proj.
INCEPTION_SPECS = {
    "mixed3a": (64, 96, 128, 16, 32, 32),
    "mixed3b": (128, 128, 192, 32, 96, 64),
    "mixed4a": (192, 96, 208, 16, 48, 64),
    "mixed4b": (160, 112, 224, 24, 64, 64),
    "mixed4c": (128, 128, 256, 24, 64, 64),
    "mixed4d": (112, 144, 288, 32, 64, 64),
    "mixed4e": (256, 160, 320, 32, 128, 128),
    "mixed5a": (256, 160, 320, 32, 128, 128),
    "mixed5b": (384, 192, 384, 48, 128, 128),
}

_BRANCHES = ("b1", "b2_red", "b2", "b3_red", "b3", "b4")


def inception_stage(name: str) -> Stage:
    ch1, ch3r, ch3, ch5r, ch5, proj = INCEPTION_SPECS[name]

    def init(gen, in_shape):
        cin = in_shape[-1]
        specs = {"b1": (cin, ch1, 1), "b2_red": (cin, ch3r, 1), "b2": (ch3r, ch3, 3),
                 "b3_red": (cin, ch5r, 1), "b3": (ch5r, ch5, 3), "b4": (cin, proj, 1)}
        parts = {b: _bc_init(gen, *specs[b]) for b in _BRANCHES}
        return {b: v[0] for b, v in parts.items()}, {b: v[1] for b, v in parts.items()}

    def apply(p, s, x):
        b1 = _bc_apply(p["b1"], s["b1"], x, 1, 0)
        b2 = _bc_apply(p["b2"], s["b2"], _bc_apply(p["b2_red"], s["b2_red"], x, 1, 0), 1, 1)
        # torchvision uses a 3x3 kernel in the "5x5" branch (its documented deviation)
        b3 = _bc_apply(p["b3"], s["b3"], _bc_apply(p["b3_red"], s["b3_red"], x, 1, 0), 1, 1)
        pooled = F.max_pool2d(x, 3, 1, 1)  # pads with -inf
        b4 = _bc_apply(p["b4"], s["b4"], pooled, 1, 0)
        return torch.cat([b1, b2, b3, b4], dim=1)

    def out_shape(s):
        return (s[0], s[1], ch1 + ch3 + ch5 + proj)

    return Stage(name, init, apply, out_shape)


def make_googlenet(num_classes: int = 1000) -> SeqNet:
    return SeqNet([
        basic_conv_stage("conv1", 64, 7, stride=2, pad=3),
        maxpool("maxpool1", 3, 2, ceil_mode=True),
        basic_conv_stage("conv2", 64, 1),
        basic_conv_stage("conv3", 192, 3, pad=1),
        maxpool("maxpool2", 3, 2, ceil_mode=True),
        inception_stage("mixed3a"),
        inception_stage("mixed3b"),
        maxpool("maxpool3", 3, 2, ceil_mode=True),
        inception_stage("mixed4a"),
        inception_stage("mixed4b"),
        inception_stage("mixed4c"),
        inception_stage("mixed4d"),
        inception_stage("mixed4e"),
        maxpool("maxpool4", 2, 2, ceil_mode=True),
        inception_stage("mixed5a"),
        inception_stage("mixed5b"),
        global_avgpool("avgpool"),
        fn_stage("dropout", lambda x: x, lambda s: s),  # eval-mode identity
        linear("fc", num_classes),
    ])
