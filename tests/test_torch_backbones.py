"""The port's backbone families beyond GoogLeNet against the JAX package's, with
the JAX weights carried across by convert.backbone_from_jax: every MLP spec,
custom_mlp_9_sae_fc1 (its ``encoded`` sub-tap too), custom_cnn_1, ResNet-18 with
both stems and ResNet-50 (eval and train mode: logits, every tap and the
batch-norm running update), GoogLeNet's aux heads, the ``batchnorm`` stage on
rank-2, 3 and 4 inputs in both modes, ``layer_dimensions`` for every name the
factory builds, and the torchvision converters on state dicts built here with
torchvision's key names (no download).

Tolerances: dense nets rtol 1e-5 with atol 1e-6 of the reference's largest
magnitude (f32 products summed in other orders); conv nets rtol 1e-4 with atol
1e-4 of the largest magnitude, as test_torch_googlenet.py (f32 convolutions
summed in other orders through up to 50 layers), but ResNet-50 in train mode
rtol 1e-3 with atol 1e-3 of the largest magnitude: 53 batch norms on the
statistics of 8 images (at 32 px layer4 is 1 x 1) amplify the f32 rounding,
and each framework's f32 taps lie ~2e-4 of the largest magnitude from the
port's f64 (both measured on this input). A net's running statistics are
held as its taps; the ``batchnorm`` stage alone rtol 1e-5 with atol 1e-6 of
the largest magnitude. Converters: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models import backbone as jbackbone
from sparse_vision_tpu.models import googlenet as jgooglenet
from sparse_vision_tpu.models import layers as jl
from sparse_vision_tpu.models import resnet as jresnet
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import backbone as tbackbone
from sparse_vision_tpu_torch.models import googlenet as tgooglenet
from sparse_vision_tpu_torch.models import layers as tl
from sparse_vision_tpu_torch.models import resnet as tresnet
from sparse_vision_tpu_torch.models.mlp import MLP_SPECS
from test_torch_pipeline import _traced_layer_dimensions


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, rtol, atol_frac):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=atol_frac * max(np.abs(j).max(), 1e-30))


def _randomize_bn(tree, rng):
    """BatchNorm scales/variances in [0.5, 1.5], biases/means N(0, 0.1), so that
    their conversion is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, size=np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


_INITS: dict = {}


def _both(name: str, dataset: str, batch: int = 2, seed: int = 0):
    """The JAX and the port's net of ``name``, the JAX init (BN randomized;
    drawn once per name) and a numpy input batch."""
    jnet = jbackbone.make_backbone(name, dataset)
    tnet = tbackbone.make_backbone(name, dataset)
    size = tuple(jnet.input_size)
    if (name, dataset, seed) not in _INITS:
        params, state = jax.device_get(
            jax.jit(lambda k: jnet.init(k, size))(jax.random.key(seed)))
        rng = np.random.default_rng(seed)
        _INITS[name, dataset, seed] = _randomize_bn(params, rng), _randomize_bn(state, rng)
    params, state = _INITS[name, dataset, seed]
    x = np.random.default_rng(seed + 1).normal(size=(batch, *size)).astype(np.float32)
    return jnet, tnet, params, state, x


def _check_forward(name: str, dataset: str, rtol: float, atol_frac: float, train: bool = False):
    # train mode normalizes by batch statistics: at 32 px ResNet's layer4 is 1 x 1,
    # and the variance of 2 samples would amplify the f32 rounding of its inputs
    jnet, tnet, params, state, x = _both(name, dataset, batch=8 if train else 2)
    jout, jtaps, jstate = jax.device_get(jax.jit(
        lambda p, s, xx: jnet.apply(p, xx, state=s, train=train))(params, state, jnp.asarray(x)))
    tp, ts = convert.backbone_from_jax(params, state)
    out, taps, new_state = tnet.apply(tp, torch.from_numpy(x), state=ts, train=train)
    assert set(taps) == set(jtaps)
    for k, v in jtaps.items():
        assert tuple(taps[k].shape) == v.shape, k
        close(taps[k], v, rtol, atol_frac)
    close(out, jout, rtol, atol_frac)
    _, want = convert.backbone_from_jax(params, jstate)
    for layer, s in want.items():
        for path, v in _leaves(s):
            close(_get(new_state[layer], path), v.numpy(), rtol, atol_frac)
    return taps


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", sorted(MLP_SPECS))
def test_mlp_specs_match_jax(name):
    _check_forward(name, "mnist", 1e-5, 1e-6)


def test_mlp9_with_sae_and_its_encoded_subtap_match_jax():
    taps = _check_forward("custom_mlp_9_sae_fc1", "mnist", 1e-5, 1e-6)
    assert tuple(taps["sae_fc1.encoded"].shape) == (2, 16)
    assert bool((taps["sae_fc1.encoded"] >= 0).all())


def test_cnn1_matches_jax():
    _check_forward("custom_cnn_1", "cifar_10", 1e-4, 1e-4)


@pytest.mark.parametrize("name", ["resnet18", "resnet18_1"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet18_both_stems_match_jax(name, train):
    taps = _check_forward(name, "cifar_10", 1e-4, 1e-4, train=train)
    # the surgery stem keeps 32 px through conv1; the ImageNet stem halves twice
    assert taps["layer1.0"].shape[1] == (32 if name == "resnet18" else 8)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet50_matches_jax(train):
    tol = 1e-3 if train else 1e-4  # the module docstring says why
    _check_forward("resnet50", "cifar_10", tol, tol, train=train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", [(6, 5), (4, 7, 5), (3, 4, 6, 5)], ids=["2d", "3d", "4d"])
def test_batchnorm_stage_matches_jax(shape, train):
    """The stage on [B, C], [B, N, C] and NHWC input: the output, and in train
    mode the running update (momentum 0.1 toward the batch mean and the
    unbiased batch variance); in eval the state is returned as it was."""
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, size=shape).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
         "bias": rng.normal(0, 0.1, 5).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.1, 5).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    jnet, tnet = jl.SeqNet([jl.batchnorm("bn")]), tl.SeqNet([tl.batchnorm("bn")])
    jout, _, jstate = jnet.apply({"bn": p}, jnp.asarray(x), state={"bn": s}, train=train)
    ts = {"bn": {k: torch.from_numpy(v) for k, v in s.items()}}
    out, _, new_state = tnet.apply({"bn": {k: torch.from_numpy(v) for k, v in p.items()}},
                                   torch.from_numpy(x), state=ts, train=train)
    close(out, jout, 1e-5, 1e-6)
    for k in ("mean", "var"):
        close(new_state["bn"][k], jstate["bn"][k], 1e-5, 1e-6)
    if not train:
        assert new_state["bn"] is ts["bn"]


def test_googlenet_aux_heads_match_jax():
    """Both heads on 5 x 5 taps, where torch's adaptive 4 x 4 windows overlap,
    from the JAX init carried across (conv, BN and both linears)."""
    rng = np.random.default_rng(2)
    params, state = jax.device_get(jgooglenet.init_googlenet_aux(jax.random.key(3), 10))
    params, state = _randomize_bn(params, rng), _randomize_bn(state, rng)
    taps = {tap: rng.normal(size=(2, 5, 5, c)).astype(np.float32)
            for tap, c in jgooglenet.AUX_TAPS.values()}
    jout = jgooglenet.apply_googlenet_aux(params, state, {k: jnp.asarray(v)
                                                          for k, v in taps.items()})
    tp, ts = convert.backbone_from_jax(params, state)
    out = tgooglenet.apply_googlenet_aux(tp, ts, {k: torch.from_numpy(v)
                                                  for k, v in taps.items()})
    assert set(out) == set(jout) == {"aux1", "aux2"}
    for k in out:
        assert tuple(out[k].shape) == (2, 10)
        close(out[k], jout[k], 1e-4, 1e-5)


def _dataset_for(name: str) -> str:
    """A dataset whose images every net of ``name``'s family takes."""
    if name.startswith("custom_mlp"):
        return "mnist"
    return "cifar_10" if name == "custom_cnn_1" else "imagenet"


@pytest.mark.parametrize("name", tbackbone.BACKBONES)
def test_layer_dimensions_match_jax_for_every_factory_name(name):
    ds = _dataset_for(name)
    jnet = jbackbone.make_backbone(name, ds)
    tnet = tbackbone.make_backbone(name, ds)
    assert tuple(tnet.input_size) == tuple(jnet.input_size)
    assert tnet.stage_names == jnet.stage_names
    td = tbackbone.layer_dimensions(tnet, ds)
    assert td == _traced_layer_dimensions(jnet, ds)
    tap = next(n for n in tnet.stage_names if n not in ("flatten",))
    assert tbackbone.get_sae_input_size(tnet, ds, tap) == td[tap][-1]


def _torchvision_resnet_sd(params: dict, state: dict, bottleneck: bool) -> dict:
    """A torchvision-keyed state dict (numpy) of a port ResNet's trees."""
    sd = {}

    def bn(prefix, p, s):
        sd.update({f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
                   f"{prefix}.running_mean": s["mean"], f"{prefix}.running_var": s["var"],
                   f"{prefix}.num_batches_tracked": np.int64(0)})

    sd["conv1.weight"] = params["conv1"]["w"]
    if "b" in params["conv1"]:
        sd["conv1.bias"] = params["conv1"]["b"]
    bn("bn1", params["bn1"], state["bn1"])
    for layer, p in params.items():
        if not layer.startswith("layer"):
            continue
        for c in (1, 2, 3) if bottleneck else (1, 2):
            sd[f"{layer}.conv{c}.weight"] = p[f"conv{c}"]["w"]
            bn(f"{layer}.bn{c}", p[f"bn{c}"], state[layer][f"bn{c}"])
        if "down_conv" in p:
            sd[f"{layer}.downsample.0.weight"] = p["down_conv"]["w"]
            bn(f"{layer}.downsample.1", p["down_bn"], state[layer]["down_bn"])
    sd["fc.weight"], sd["fc.bias"] = params["fc"]["w"], params["fc"]["b"]
    return {k: np.asarray(v) for k, v in sd.items()}


def _rand_like(tree: dict, rng) -> dict:
    return {k: _rand_like(v, rng) if isinstance(v, dict) else
            torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in tree.items()}


def _same_tree(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,stem", [("resnet18", True), ("resnet18_1", False),
                                       ("resnet50", None)])
def test_torchvision_resnet_converters_match_jax(name, stem):
    """The port's converter on a torchvision-keyed state dict equals the JAX
    converter's result carried across, and gives back the trees it came from;
    a surgery stem without conv1.bias gets zeros."""
    tnet = tbackbone.make_backbone(name, "cifar_10")
    params, state = tnet.init(torch.Generator().manual_seed(4), (32, 32, 3))
    state = _rand_like(state, np.random.default_rng(4))
    sd = _torchvision_resnet_sd(params, state, bottleneck=name == "resnet50")
    if name == "resnet50":
        got, jgot = tresnet.convert_torchvision_resnet50(sd), \
            jresnet.convert_torchvision_resnet50(sd)
    else:
        got = tresnet.convert_torchvision_resnet18(sd, tiny_imagenet_stem=stem)
        jgot = jresnet.convert_torchvision_resnet18(sd, tiny_imagenet_stem=stem)
    _same_tree(got[0], params)
    _same_tree(got[1], state)
    want = convert.backbone_from_jax(*jax.device_get(jgot))
    _same_tree(got[0], want[0])
    _same_tree(got[1], want[1])
    if stem:
        del sd["conv1.bias"]
        p = tresnet.convert_torchvision_resnet18(sd, tiny_imagenet_stem=True)[0]
        assert torch.equal(p["conv1"]["b"], torch.zeros(64))


def test_torchvision_googlenet_aux_converter_matches_jax():
    params, state = tgooglenet.init_googlenet_aux(torch.Generator().manual_seed(5), 10)
    sd = {}
    for name in tgooglenet.AUX_TAPS:
        c = params[name]["conv"]
        sd.update({f"{name}.conv.conv.weight": c["w"], f"{name}.conv.bn.weight": c["scale"],
                   f"{name}.conv.bn.bias": c["bias"],
                   f"{name}.conv.bn.running_mean": state[name]["conv"]["mean"] + 0.1,
                   f"{name}.conv.bn.running_var": state[name]["conv"]["var"] * 2})
        for fc in ("fc1", "fc2"):
            sd[f"{name}.{fc}.weight"] = params[name][fc]["w"]
            sd[f"{name}.{fc}.bias"] = params[name][fc]["b"]
    sd = {k: v.numpy() for k, v in sd.items()}
    got = tgooglenet.convert_torchvision_googlenet_aux(sd)
    want = convert.backbone_from_jax(
        *jax.device_get(jgooglenet.convert_torchvision_googlenet_aux(sd)))
    _same_tree(got[0], want[0])
    _same_tree(got[1], want[1])
    _same_tree(got[0], params)
