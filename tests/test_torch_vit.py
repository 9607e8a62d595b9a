"""The port's ViT and CLIP vision towers against the JAX package's (mirrors
tests/test_vit.py): vit_test and clip_vit_test, fused and split, logits and the
tap of every stage with the JAX weights carried across by
convert.backbone_from_jax; the split tower equal to the fused one on the same
parameters; both HF converters against the JAX converters on state dicts built
here with HF's key names (no download); the 229 px ImageNet stand-in refused by
the patch embedding (ROADMAP C7) in both packages; and both Pipelines on 32 px
images (65 tokens an image): an SAE on a block tap (cached), an SAE on an
attention-out tap (uncached, the JAX default), the split tower's MLP
transcoder block0_attn -> block0_mlp and a crosscoder across the two blocks.

Tolerances: forwards rtol 1e-5 with atol 1e-5 of the largest magnitude (f32
layer norms, softmax and products summed in other orders); split against fused
the same, in the port alone; converters exact. The Pipelines as
test_torch_pipeline.py holds them: per-step losses rtol 1e-4, final parameters
rtol 2e-3 with atol 2e-5, eval means rtol 1e-4, loss_diff and kld atol 1e-5,
counting metrics exact.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.models import backbone as jbackbone
from sparse_vision_tpu.models import vit as jvit
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.models import backbone as tbackbone
from sparse_vision_tpu_torch.models import vit as tvit
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from test_torch_backbones import _same_tree
from test_torch_pipeline import _check_means, _Recorder, quick_jax_pipeline

SIZE = (32, 32, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, rtol=1e-5, atol_frac=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=atol_frac * max(np.abs(j).max(), 1e-30))


_INITS: dict = {}


def _jax_init(name: str, dataset: str = "cifar_10", seed: int = 0):
    key = (name, dataset, seed)
    if key not in _INITS:
        net = jbackbone.make_backbone(name, dataset)
        size = tuple(net.input_size)
        _INITS[key] = jax.device_get(jax.jit(lambda k: net.init(k, size))(jax.random.key(seed)))
    return _INITS[key]


def _x(batch: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(batch, *SIZE)).astype(np.float32)


@pytest.mark.parametrize("name", ["vit_test", "vit_test_split", "clip_vit_test",
                                  "clip_vit_test_split"])
def test_towers_match_jax_at_every_tap(name):
    jnet = jbackbone.make_backbone(name, "cifar_10")
    tnet = tbackbone.make_backbone(name, "cifar_10")
    params, _ = _jax_init(name)
    x = _x()
    jout, jtaps, _ = jax.device_get(jax.jit(lambda p, xx: jnet.apply(p, xx))(params,
                                                                              jnp.asarray(x)))
    tp, _ = convert.backbone_from_jax(params, {})
    with torch.no_grad():
        out, taps, _ = tnet.apply(tp, torch.from_numpy(x))
    assert list(taps) == list(tnet.stage_names) and set(taps) == set(jtaps)
    for k, v in jtaps.items():
        assert tuple(taps[k].shape) == v.shape, k
        close(taps[k], v)
    close(out, jout)
    blocks = [k for k in taps if k.startswith("block")]
    assert len(blocks) == (4 if name.endswith("_split") else 2)
    assert all(tuple(taps[k].shape) == (2, 65, 64) for k in blocks)  # 64 patches + CLS


@pytest.mark.parametrize("spec", ["vit_test", "clip_vit_test"])
def test_split_tower_equals_fused_on_the_same_parameters(spec):
    """block{i}_attn + block{i}_mlp with re-keyed parameters compute the fused
    block{i}; the attention tap is a surface of its own."""
    fused = tbackbone.make_backbone(spec, "cifar_10")
    split = tbackbone.make_backbone(f"{spec}_split", "cifar_10")
    params, _ = fused.init(torch.Generator().manual_seed(0), SIZE)
    sparams = tvit.split_converted_blocks(params, depth=2)
    x = torch.from_numpy(_x(seed=1))
    with torch.no_grad():
        out_f, taps_f, _ = fused.apply(params, x)
        out_s, taps_s, _ = split.apply(sparams, x)
    close(out_s, out_f.numpy())
    for i in range(2):
        close(taps_s[f"block{i}_mlp"], taps_f[f"block{i}"].numpy())
    attn0 = taps_s["block0_attn"]
    assert not torch.allclose(attn0, taps_f["block0"])
    assert tbackbone.get_sae_input_size(split, "cifar_10", "block1_attn") == 64


def _hf_vit_sd(p: dict) -> dict:
    """An HF ViTForImageClassification-keyed state dict of port parameters."""
    e = "vit.embeddings."
    sd = {e + "patch_embeddings.projection.weight": p["patch_embed"]["proj_w"],
          e + "patch_embeddings.projection.bias": p["patch_embed"]["proj_b"],
          e + "cls_token": p["patch_embed"]["cls"][None, None],
          e + "position_embeddings": p["patch_embed"]["pos"][None],
          "vit.layernorm.weight": p["ln_final"]["scale"],
          "vit.layernorm.bias": p["ln_final"]["bias"],
          "classifier.weight": p["head"]["w"], "classifier.bias": p["head"]["b"]}
    for i in range(2):
        b, pre = p[f"block{i}"], f"vit.encoder.layer.{i}."
        names = {"ln1": "layernorm_before", "ln2": "layernorm_after",
                 "q": "attention.attention.query", "k": "attention.attention.key",
                 "v": "attention.attention.value", "o": "attention.output.dense",
                 "mlp1": "intermediate.dense", "mlp2": "output.dense"}
        for ours, theirs in names.items():
            w, bb = (("scale", "bias") if ours.startswith("ln") else ("w", "b"))
            sd[f"{pre}{theirs}.weight"] = b[f"{ours}_{w}"]
            sd[f"{pre}{theirs}.bias"] = b[f"{ours}_{bb}"]
    return {k: v.numpy() for k, v in sd.items()}


def _hf_clip_sd(p: dict, projection: bool) -> dict:
    """An HF CLIPVisionModel(WithProjection)-keyed state dict of port parameters."""
    e, v = "vision_model.embeddings.", "vision_model."
    sd = {e + "patch_embedding.weight": p["patch_embed"]["proj_w"],
          e + "class_embedding": p["patch_embed"]["cls"],
          e + "position_embedding.weight": p["patch_embed"]["pos"],
          v + "pre_layrnorm.weight": p["pre_ln"]["scale"],
          v + "pre_layrnorm.bias": p["pre_ln"]["bias"],
          v + "post_layernorm.weight": p["post_ln"]["scale"],
          v + "post_layernorm.bias": p["post_ln"]["bias"]}
    if projection:
        sd["visual_projection.weight"] = p["head"]["w"]
    for i in range(2):
        b, pre = p[f"block{i}"], f"vision_model.encoder.layers.{i}."
        names = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
                 "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.out_proj",
                 "mlp1": "mlp.fc1", "mlp2": "mlp.fc2"}
        for ours, theirs in names.items():
            w, bb = (("scale", "bias") if ours.startswith("ln") else ("w", "b"))
            sd[f"{pre}{theirs}.weight"] = b[f"{ours}_{w}"]
            sd[f"{pre}{theirs}.bias"] = b[f"{ours}_{bb}"]
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("which", ["vit", "clip", "clip_projection"])
def test_hf_converters_match_jax(which):
    """The port's converter equals the JAX converter's result carried across,
    and gives back the parameters the state dict was built from (CLIP: the head
    only from visual_projection, bias-free)."""
    spec = "vit_test" if which == "vit" else "clip_vit_test"
    net = tbackbone.make_backbone(spec, "cifar_10")
    params, _ = net.init(torch.Generator().manual_seed(2), SIZE)
    if which == "vit":
        sd = _hf_vit_sd(params)
        got, jgot = tvit.convert_hf_vit(sd, depth=2), jvit.convert_hf_vit(sd, depth=2)
    else:
        sd = _hf_clip_sd(params, projection=which == "clip_projection")
        got = tvit.convert_hf_clip_vision(sd, depth=2)
        jgot = jvit.convert_hf_clip_vision(sd, depth=2)
        if which == "clip":
            assert "head" not in got and "head" not in jgot
            params = {k: v for k, v in params.items() if k != "head"}
        else:
            params = {**params, "head": {"w": params["head"]["w"], "b": torch.zeros(10)}}
    _same_tree(got, params)
    _same_tree(got, convert.backbone_from_jax(jax.device_get(jgot), {})[0])


# ---------------------------------------------------------------------------
# ROADMAP C7: the 229 px ImageNet stand-in through a 224 px tower
# ---------------------------------------------------------------------------

def test_c7_229px_stand_in_raises_in_the_patch_embedding_in_both_packages(tmp_path):
    """Without data_dir, load_data draws the ImageNet stand-in at the dataset's
    229 px whatever the model, and the tower's patch 16 does not divide it: both
    packages raise the same ValueError at the first forward (the dump), not
    crop. Eight 229 px images stand in for load_data's 512."""
    cfg = dict(model_name="vit_test", dataset_name="imagenet", sae_layer="block0",
               use_activation_cache=True, cache_tokens_per_step=128, sae_batch_size=4)
    size = (229, 229, 3)

    def data(make):
        tr = make(num_samples=8, img_size=size, num_classes=1000, seed=0)
        return tr, tr, tr.category_names, size

    tpipe = TPipeline(TConfig(**cfg, directory_path=str(tmp_path / "t")), device="cpu",
                      datasets=data(t_synth))
    assert tuple(tpipe.net.input_size) == (224, 224, 3)
    with pytest.raises(ValueError, match=r"not divisible by patch 16"):
        tpipe.train_sae()
    with quick_jax_pipeline():
        jpipe = JPipeline(JConfig(**cfg, directory_path=str(tmp_path / "j")),
                          datasets=data(j_synth))
        with pytest.raises(ValueError, match=r"not divisible by patch 16"):
            jpipe.train_sae()


# ---------------------------------------------------------------------------
# both Pipelines on the towers (tests/test_vit.py's runs)
# ---------------------------------------------------------------------------

CFG = dict(dataset_name="cifar_10", sae_expansion_factor=2, sae_lambda_sparse=1.0,
           sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3, sae_batch_size=16,
           cache_tokens_per_step=512, cache_dtype="float32", compute_dtype="float32",
           sae_epochs=1, dead_neurons_steps=1000, seed=3)
RUNS = {
    # test_vit.py's test_vit_pipeline_e2e / test_clip_pipeline_e2e
    "vit_block_sae": dict(model_name="vit_test", sae_layer="block0",
                          use_activation_cache=True),
    "clip_block_sae": dict(model_name="clip_vit_test", sae_layer="block1",
                           use_activation_cache=True),
    # test_sae_trains_on_attention_tap: uncached
    "attention_tap_sae": dict(model_name="vit_test_split", sae_layer="block0_attn"),
    # test_mlp_transcoder_on_split_vit
    "mlp_transcoder": dict(model_name="vit_test_split", sae_model_name="transcoder",
                           sae_layer="block0_attn", transcoder_target_layer="block0_mlp",
                           use_activation_cache=True),
    # test_crosscoder_across_vit_blocks
    "crosscoder": dict(model_name="vit_test", sae_model_name="crosscoder", sae_layer="block0",
                       crosscoder_layers="block1", sae_optimizer_name="adam",
                       use_activation_cache=True, sae_lambda_sparse=0.1),
}


def _datasets(make):
    tr = make(num_samples=64, img_size=SIZE, num_classes=10, seed=3)
    va = make(num_samples=32, img_size=SIZE, num_classes=10, seed=4)
    return tr, va, tr.category_names, SIZE


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request, tmp_path_factory):
    cfg = {**CFG, **RUNS[request.param]}
    jlog = _Recorder()
    with quick_jax_pipeline():
        jpipe = JPipeline(JConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("jax"))),
                          logger=jlog, datasets=_datasets(j_synth))
        backbone = convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                             jax.device_get(jpipe.net_state))
        sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
        tpipe = TPipeline(TConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("torch"))),
                          device="cpu", datasets=_datasets(t_synth), backbone=backbone,
                          sae_params=sae)
        jpipe.CACHE_SCAN_K = tpipe.CACHE_SCAN_K = 2
        jbefore = jpipe.eval_modified(epoch=0, store=False)
        jmeans = jpipe.train_sae()
    tbefore = tpipe.eval_modified(epoch=0, store=False)
    tmeans = tpipe.train_sae()
    return request.param, jpipe, jlog, jmeans, jbefore, tpipe, tmeans, tbefore


def test_pipeline_runs_match_jax(runs):
    name, jpipe, jlog, jmeans, jbefore, tpipe, tmeans, tbefore = runs
    tsteps = {s: {k: float(v) for k, v in m.items()} for s, m in tpipe.train_log}
    # 64 images of 65 tokens: 8 cached steps of 512 tokens; uncached, 4 of 16 images
    n = 4 if name == "attention_tap_sae" else 8
    assert sorted(tsteps) == list(range(1, n + 1)) and tpipe.ts.step == int(jpipe.ts.step)
    assert set(jlog.train) <= set(tsteps) and jlog.train
    for s, jm in jlog.train.items():
        for k in ("sae_loss", "sae_rec_loss", "sae_l1_loss"):
            np.testing.assert_allclose(tsteps[s][k], jm[k], rtol=1e-4, err_msg=f"step {s} {k}")
    for k, v in jpipe.ts.params.items():
        np.testing.assert_allclose(tpipe.ts.params[k].numpy(), np.asarray(v), rtol=2e-3,
                                   atol=2e-5, err_msg=k)
    _check_means((None, None, jbefore, None, tbefore))
    _check_means((None, None, jmeans, None, tmeans))
    assert np.isfinite(tmeans["kld"]) and tmeans["sae_rec_loss"] > 0
    if name in ("mlp_transcoder", "crosscoder"):  # tests/test_vit.py's claim
        assert tmeans["sae_rec_loss"] < tbefore["sae_rec_loss"]
    if name == "crosscoder":
        import os

        import pandas as pd

        jdf = pd.read_csv(os.path.join(jpipe.paths["sae_weights"],
                                       os.path.basename(tpipe.decoder_norms_path)))
        tdf = pd.read_csv(tpipe.decoder_norms_path)
        assert list(tdf.columns) == list(jdf.columns) and len(tdf) == tpipe.num_units
        np.testing.assert_allclose(tdf.to_numpy(), jdf.to_numpy(), rtol=2e-3, atol=2e-5)
