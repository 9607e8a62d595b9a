"""GoogLeNet / InceptionV1 as a SeqNet (port of sparse_vision_tpu/models/googlenet.py).

Matches torchvision's GoogLeNet: BasicConv2d = bias-free conv + BatchNorm(eps=1e-3)
+ ReLU; the inception "5x5" branch uses a 3x3 kernel; every maxpool is ceil_mode;
the pool branch pads with -inf. Stage names follow the ``mixed*`` convention.
Inputs are NHWC; at 229 px ``mixed3a`` is 28 x 28 x 256.

The aux classifiers (torchvision's InceptionAux off mixed4a and mixed4d) are
opt-in: ``init_googlenet_aux`` / ``apply_googlenet_aux`` read the taps dict
that ``SeqNet.apply`` returns, and ``convert_torchvision_googlenet_aux`` maps
torchvision's ``aux1.*`` / ``aux2.*`` weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sparse_vision_tpu_torch.models.layers import (
    SeqNet,
    Stage,
    bn_apply,
    bn_init,
    conv_out,
    fn_stage,
    global_avgpool,
    linear,
    maxpool,
    state_dict_reader,
    uniform,
)

_BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm2d(eps=0.001)


def _bc_init(gen: torch.Generator, cin: int, cout: int, k: int):
    w = uniform(gen, (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k))
    bn_p, state = bn_init(cout, gen.device)
    return {"w": w, **bn_p}, state


def _bc_apply(p: dict, s: dict, x: torch.Tensor, train: bool, stride: int, pad: int):
    """BasicConv2d: (relu(bn(conv(x))), new BN state)."""
    y = F.conv2d(x, p["w"], stride=stride, padding=pad)
    y, new_s = bn_apply(p, s, y, train, _BN_EPS)
    return torch.relu(y), new_s


def basic_conv_stage(name: str, cout: int, k: int, stride: int = 1, pad: int = 0) -> Stage:
    def apply(p, st, x, train):
        y, new_s = _bc_apply(p, st, x, train, stride, pad)
        return y, new_s, None

    def out_shape(s):
        h, w, _ = s
        return conv_out(h, k, stride, pad), conv_out(w, k, stride, pad), cout

    return Stage(name, lambda gen, s: _bc_init(gen, s[-1], cout, k), apply, out_shape)


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

    def apply(p, s, x, train):
        new_s = {}
        b1, new_s["b1"] = _bc_apply(p["b1"], s["b1"], x, train, 1, 0)
        t, new_s["b2_red"] = _bc_apply(p["b2_red"], s["b2_red"], x, train, 1, 0)
        b2, new_s["b2"] = _bc_apply(p["b2"], s["b2"], t, train, 1, 1)
        # torchvision uses a 3x3 kernel in the "5x5" branch (its documented deviation)
        t, new_s["b3_red"] = _bc_apply(p["b3_red"], s["b3_red"], x, train, 1, 0)
        b3, new_s["b3"] = _bc_apply(p["b3"], s["b3"], t, train, 1, 1)
        pooled = F.max_pool2d(x, 3, 1, 1)  # pads with -inf
        b4, new_s["b4"] = _bc_apply(p["b4"], s["b4"], pooled, train, 1, 0)
        return torch.cat([b1, b2, b3, b4], dim=1), new_s, None

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


# ---------------------------------------------------------------------------
# aux classifiers (torchvision InceptionAux), opt-in
# ---------------------------------------------------------------------------

# head -> (tap layer, input channels): aux1 off inception4a, aux2 off inception4d
AUX_TAPS = {"aux1": ("mixed4a", 512), "aux2": ("mixed4d", 528)}


def init_googlenet_aux(generator: torch.Generator, num_classes: int = 1000) -> tuple:
    """(params, state) of both aux heads: adaptive avgpool 4x4 -> BasicConv2d(in,
    128, 1) -> fc1 2048 -> 1024 + ReLU (+ dropout 0.7 in torch's train mode) ->
    fc2 1024 -> num_classes."""
    params, state = {}, {}
    for name, (_, cin) in AUX_TAPS.items():
        conv_p, conv_s = _bc_init(generator, cin, 128, 1)
        b1, b2 = 1.0 / math.sqrt(2048), 1.0 / math.sqrt(1024)
        params[name] = {
            "conv": conv_p,
            "fc1": {"w": uniform(generator, (1024, 2048), b1),
                    "b": uniform(generator, (1024,), b1)},
            "fc2": {"w": uniform(generator, (num_classes, 1024), b2),
                    "b": uniform(generator, (num_classes,), b2)},
        }
        state[name] = {"conv": conv_s}
    return params, state


def apply_googlenet_aux(params: dict, state: dict, taps: dict) -> dict:
    """Aux logits from the (NHWC) taps dict of SeqNet.apply, in eval mode
    (dropout is the identity), as torch's eval-mode InceptionAux."""
    out = {}
    for name, (tap, _) in AUX_TAPS.items():
        p = params[name]
        x = F.adaptive_avg_pool2d(taps[tap].permute(0, 3, 1, 2), 4)
        x, _ = _bc_apply(p["conv"], state[name]["conv"], x, False, 1, 0)
        x = torch.relu(F.linear(x.reshape(x.shape[0], -1), p["fc1"]["w"], p["fc1"]["b"]))
        out[name] = F.linear(x, p["fc2"]["w"], p["fc2"]["b"])
    return out


def _bc_from_torch(t, prefix: str) -> tuple:
    return ({"w": t(f"{prefix}.conv.weight"), "scale": t(f"{prefix}.bn.weight"),
             "bias": t(f"{prefix}.bn.bias")},
            {"mean": t(f"{prefix}.bn.running_mean"), "var": t(f"{prefix}.bn.running_var")})


def convert_torchvision_googlenet_aux(state_dict: dict) -> tuple:
    """torchvision's ``aux1.*`` / ``aux2.*`` weights -> the (params, state) of
    apply_googlenet_aux, in the port's layout (torch's own: no transposes)."""
    t = state_dict_reader(state_dict)
    params, state = {}, {}
    for name in AUX_TAPS:
        conv_p, conv_s = _bc_from_torch(t, f"{name}.conv")
        params[name] = {"conv": conv_p,
                        "fc1": {"w": t(f"{name}.fc1.weight"), "b": t(f"{name}.fc1.bias")},
                        "fc2": {"w": t(f"{name}.fc2.weight"), "b": t(f"{name}.fc2.bias")}}
        state[name] = {"conv": conv_s}
    return params, state
