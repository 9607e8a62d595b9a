"""ResNet-18 and ResNet-50 as SeqNets, with torchvision weight converters (port of
sparse_vision_tpu/models/resnet.py).

ResNet-18 comes with two stems: the ImageNet one ('resnet18_1': 7x7 stride-2
conv without bias, BN, ReLU, maxpool) and the reference's Tiny-ImageNet
surgery ('resnet18' / 'resnet18_2': a 3x3 stride-1 conv *with* bias and no
maxpool, so 64 px inputs keep their detail). Stage names follow torchvision
(conv1, bn1, relu, maxpool, layer1.0 .. layer4.1, avgpool, fc); each residual
block is one stage, whose output (after the final ReLU) is what a forward hook
on the torch block sees. Batch norm has eps 1e-5 and momentum 0.1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sparse_vision_tpu_torch.models.layers import (
    SeqNet,
    Stage,
    batchnorm,
    bn_apply,
    bn_init,
    conv,
    conv_out,
    global_avgpool,
    linear,
    maxpool,
    relu,
    state_dict_reader,
    uniform,
)

_BN_EPS = 1e-5


def _conv_w(gen: torch.Generator, cin: int, cout: int, k: int) -> torch.Tensor:
    return uniform(gen, (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k))


def _bn(p: dict, s: dict, new_s: dict, key: str, x: torch.Tensor, train: bool):
    y, new_s[key] = bn_apply(p[key], s[key], x, train, _BN_EPS)
    return y


def _block(name: str, cout: int, stride: int, convs: tuple) -> Stage:
    """A residual block: ``convs`` = ((width, kernel, stride), ...) each followed
    by BN (and a ReLU but for the last), plus the skip (a 1x1 conv + BN where
    the shape changes), then a ReLU."""

    def init(gen, in_shape):
        cin = in_shape[-1]
        params, state = {}, {}
        c = cin
        for i, (width, k, _) in enumerate(convs, start=1):
            params[f"conv{i}"] = {"w": _conv_w(gen, c, width, k)}
            params[f"bn{i}"], state[f"bn{i}"] = bn_init(width, gen.device)
            c = width
        if stride != 1 or cin != cout:
            params["down_conv"] = {"w": _conv_w(gen, cin, cout, 1)}
            params["down_bn"], state["down_bn"] = bn_init(cout, gen.device)
        return params, state

    def apply(params, state, x, train):
        new_s = {}
        y = x
        for i, (_, k, s) in enumerate(convs, start=1):
            y = F.conv2d(y, params[f"conv{i}"]["w"], stride=s, padding=k // 2)
            y = _bn(params, state, new_s, f"bn{i}", y, train)
            if i < len(convs):
                y = torch.relu(y)
        if "down_conv" in params:
            sk = F.conv2d(x, params["down_conv"]["w"], stride=stride)
            sk = _bn(params, state, new_s, "down_bn", sk, train)
        else:
            sk = x
        return torch.relu(y + sk), new_s, None

    def out_shape(s):
        h, w, _ = s
        return conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1), cout

    return Stage(name, init, apply, out_shape)


def basic_block(name: str, cout: int, stride: int = 1) -> Stage:
    """torchvision BasicBlock: conv3x3(stride)-bn-relu-conv3x3-bn + skip, ReLU."""
    return _block(name, cout, stride, ((cout, 3, stride), (cout, 3, 1)))


def bottleneck_block(name: str, width: int, stride: int = 1) -> Stage:
    """torchvision Bottleneck: 1x1(width)-bn-relu, 3x3(width, stride)-bn-relu,
    1x1(width*4)-bn + skip, ReLU."""
    return _block(name, width * 4, stride, ((width, 1, 1), (width, 3, stride), (width * 4, 1, 1)))


def _imagenet_stem() -> list:
    return [conv("conv1", 64, kernel=7, stride=2, padding=3, use_bias=False),
            batchnorm("bn1", _BN_EPS), relu("relu"), maxpool("maxpool", 3, 2, padding=1)]


def make_resnet50(num_classes: int = 1000) -> SeqNet:
    """torchvision resnet50: Bottleneck blocks [3, 4, 6, 3], ImageNet stem."""
    stages = _imagenet_stem()
    for lname, width, blocks, stride in (("layer1", 64, 3, 1), ("layer2", 128, 4, 2),
                                         ("layer3", 256, 6, 2), ("layer4", 512, 3, 2)):
        stages += [bottleneck_block(f"{lname}.{b}", width, stride if b == 0 else 1)
                   for b in range(blocks)]
    return SeqNet(stages + [global_avgpool("avgpool"), linear("fc", num_classes)])


def make_resnet18(num_classes: int = 200, tiny_imagenet_stem: bool = True) -> SeqNet:
    if tiny_imagenet_stem:
        stages = [conv("conv1", 64, kernel=3, stride=1, padding=1),
                  batchnorm("bn1", _BN_EPS), relu("relu")]
    else:
        stages = _imagenet_stem()
    for lname, c, s in (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 2),
                        ("layer4", 512, 2)):
        stages += [basic_block(f"{lname}.0", c, stride=s), basic_block(f"{lname}.1", c)]
    return SeqNet(stages + [global_avgpool("avgpool"), linear("fc", num_classes)])


# ---------------------------------------------------------------------------
# torchvision weight converters: torch's layout is the port's, so only the
# keys change
# ---------------------------------------------------------------------------

def _bn_from_torch(t, prefix: str) -> tuple:
    return ({"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")},
            {"mean": t(f"{prefix}.running_mean"), "var": t(f"{prefix}.running_var")})


def _blocks_from_torch(sd: dict, t, blocks: tuple, n_convs: int, params: dict,
                       state: dict) -> None:
    for li, n in enumerate(blocks, start=1):
        for bi in range(n):
            tv = f"layer{li}.{bi}"
            p = {f"conv{c}": {"w": t(f"{tv}.conv{c}.weight")} for c in range(1, n_convs + 1)}
            s = {}
            for c in range(1, n_convs + 1):
                p[f"bn{c}"], s[f"bn{c}"] = _bn_from_torch(t, f"{tv}.bn{c}")
            if f"{tv}.downsample.0.weight" in sd:
                p["down_conv"] = {"w": t(f"{tv}.downsample.0.weight")}
                p["down_bn"], s["down_bn"] = _bn_from_torch(t, f"{tv}.downsample.1")
            params[tv], state[tv] = p, s


def convert_torchvision_resnet50(state_dict: dict) -> tuple:
    """A torchvision resnet50 state_dict -> the SeqNet's (params, state)."""
    t = state_dict_reader(state_dict)
    params, state = {"conv1": {"w": t("conv1.weight")}}, {}
    params["bn1"], state["bn1"] = _bn_from_torch(t, "bn1")
    _blocks_from_torch(state_dict, t, (3, 4, 6, 3), 3, params, state)
    params["fc"] = {"w": t("fc.weight"), "b": t("fc.bias")}
    return params, state


def convert_torchvision_resnet18(state_dict: dict, tiny_imagenet_stem: bool = True) -> tuple:
    """A torchvision resnet18 state_dict, with the ImageNet stem or the
    reference's biased 3x3 surgery stem, -> the SeqNet's (params, state). A
    surgery stem without ``conv1.bias`` gets a zero bias."""
    t = state_dict_reader(state_dict)
    params, state = {"conv1": {"w": t("conv1.weight")}}, {}
    if "conv1.bias" in state_dict:
        params["conv1"]["b"] = t("conv1.bias")
    elif tiny_imagenet_stem:
        params["conv1"]["b"] = torch.zeros(params["conv1"]["w"].shape[0])
    params["bn1"], state["bn1"] = _bn_from_torch(t, "bn1")
    _blocks_from_torch(state_dict, t, (2, 2, 2, 2), 2, params, state)
    params["fc"] = {"w": t("fc.weight"), "b": t("fc.bias")}
    return params, state
