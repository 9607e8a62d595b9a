"""Multi-layer training from one backbone pass: the JAX package's
train/multilayer.py and the port's on the same data and the same initial
weights. The JAX functions build their own Pipelines (datasets from
load_data, weights from the seed), so the JAX side sees this file's synthetic
data through a monkeypatched ``sparse_vision_tpu.train.pipeline.load_data``;
the port gets the same data, the JAX backbone (convert.py) and the JAX
initial dictionaries through its keyword pass-throughs and a monkeypatched
init in its pipeline module.

Shapes: GoogLeNet at 32 px (mixed4c..4e are 2 x 2 x 512 / 528 / 832), 256
train and 64 validation images, the registry's hyperparameters (expansion 4,
λ 0.1, ConstrainedAdam at lr 1e-3, batch 256: one dump batch), 128 tokens a
step, so each layer's 1,024 tokens make one full stack of CACHE_SCAN_K = 8
steps; f32 cache and compute. mixed4d's SAE and the mixed4d -> mixed4e
transcoder have 2,112 latents: the port trains them through its padded fused
op (the plain versions on the CPU), JAX through its stock step (its fused op
does not tile 2,112, and on the CPU it never fuses).

Tolerances (tests/test_torch_pipeline.py's, whose reasons hold here): the two
frameworks' f32 convolutions differ by ~1e-6 relative, which training
carries; final weights rtol 2e-3 / atol 2e-5, eval means rtol 1e-4 / atol
1e-7, loss_diff and kld atol 1e-5, the counting metrics (perc_same,
perc_dead_units, accuracy) within 1e-6.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data import activation_cache as j_cache
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.models.backbone import init_backbone as j_init_backbone
from sparse_vision_tpu.models.backbone import make_backbone as j_make_backbone
from sparse_vision_tpu.models.sae import init_sae as j_init_sae
from sparse_vision_tpu.models.sae import init_transcoder as j_init_transcoder
from sparse_vision_tpu.train import multilayer as j_ml
from sparse_vision_tpu.train import pipeline as j_pipeline
from sparse_vision_tpu.utils import paths as j_paths
from sparse_vision_tpu_torch import cli, convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data import activation_cache as t_cache
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.interp.registry import CIRCUIT_LAYERS
from sparse_vision_tpu_torch.models.backbone import make_backbone as t_make_backbone
from sparse_vision_tpu_torch.train import multilayer as t_ml
from sparse_vision_tpu_torch.train import pipeline as t_pipeline
from sparse_vision_tpu_torch.utils import paths as t_paths

SIZE = (32, 32, 3)
SEED = 3
BASE = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed4c",
            sae_epochs=1, use_activation_cache=True, cache_tokens_per_step=128,
            cache_dtype="float32", compute_dtype="float32", eval_batch_size=32, seed=SEED)
LAYERS = ("mixed4c", "mixed4d", "mixed4e")
C_OF = {"mixed4c": 512, "mixed4d": 528, "mixed4e": 832}
VAL_TOKENS = 64 * 4  # 64 validation images of 2 x 2 tokens
# sparsity counts the active latents of each validation token: a pre-activation
# within rounding of 0 can switch a latent between the frameworks, which moves
# it by 1 / (C·tokens). Held as a count of such switches over the 256 tokens
# (measured: 4 of 852k token-latent pairs, mixed4e's SAE; 0 elsewhere)
MAX_SWITCHES = 8
PAIRS = (("mixed4c", "mixed4d"), ("mixed4d", "mixed4e"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _datasets(make):
    tr = make(num_samples=256, img_size=SIZE, num_classes=1000, seed=SEED)
    va = make(num_samples=64, img_size=SIZE, num_classes=1000, seed=SEED + 1)
    return tr, va, tr.category_names, SIZE


def _j_sae_key():
    return jax.random.split(jax.random.key(SEED))[1]  # the JAX Pipeline's k_sae


class Counter:
    """Wraps a dump function and records the layers of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, net, params, state, dataset, layers, *args, **kwargs):
        self.calls.append(list(layers))
        return self.fn(net, params, state, dataset, layers, *args, **kwargs)


def _patch(monkeypatch):
    """Both packages' Pipelines see this file's data and JAX's initial
    weights; returns (jax dump counter, port dump counter, port kwargs)."""
    monkeypatch.setattr(j_pipeline, "load_data", lambda cfg, class_filter=None: _datasets(j_synth))
    jnet = j_make_backbone("inceptionv1", "imagenet")
    k_model, _ = jax.random.split(jax.random.key(SEED))
    backbone = convert.backbone_from_jax(*jax.device_get(j_init_backbone(jnet, k_model,
                                                                         "imagenet")))

    def init_sae(name, gen, d, ef, **kw):
        return convert.sae_params_from_jax(jax.device_get(j_init_sae(name, _j_sae_key(), d, ef)))

    def init_transcoder(gen, d_in, ef, d_out):
        return convert.sae_params_from_jax(jax.device_get(
            j_init_transcoder(_j_sae_key(), d_in, ef, d_out)))

    monkeypatch.setattr(t_pipeline, "init_sae", init_sae)
    monkeypatch.setattr(t_pipeline, "init_transcoder", init_transcoder)
    jdump, tdump = Counter(j_cache.dump_activations_multi), Counter(t_cache.dump_activations_multi)
    monkeypatch.setattr(j_cache, "dump_activations_multi", jdump)
    monkeypatch.setattr(t_cache, "dump_activations_multi", tdump)
    for mod in (j_cache, t_cache):  # no layer may be dumped alone
        monkeypatch.setattr(mod, "dump_activations", _no_single_dump)
    return jdump, tdump, {"device": "cpu", "datasets": _datasets(t_synth), "backbone": backbone}


def _no_single_dump(*args, **kwargs):
    raise AssertionError("a layer cache was dumped on its own, not in the one pass")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' train_saes_multilayer over LAYERS and
    train_transcoders_multilayer over PAIRS, each in a directory of its own."""
    mp = pytest.MonkeyPatch()
    try:
        jdump, tdump, kwargs = _patch(mp)
        jroot, troot = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
        jbase = JConfig(**BASE, directory_path=str(jroot))
        tbase = TConfig(**BASE, directory_path=str(troot))
        out = {"jbase": jbase, "tbase": tbase, "kwargs": kwargs, "jdump": jdump, "tdump": tdump}
        out["j_sae"] = j_ml.train_saes_multilayer(jbase, layers=list(LAYERS))
        out["t_sae"] = t_ml.train_saes_multilayer(tbase, layers=list(LAYERS), **kwargs)
        out["sae_dumps"] = (list(jdump.calls), list(tdump.calls))
        out["j_tc"] = j_ml.train_transcoders_multilayer(jbase, pairs=list(PAIRS))
        out["t_tc"] = t_ml.train_transcoders_multilayer(tbase, pairs=list(PAIRS), **kwargs)
        out["tc_dumps"] = (jdump.calls[len(out["sae_dumps"][0]):],
                           tdump.calls[len(out["sae_dumps"][1]):])
        yield out
    finally:
        mp.undo()


def _check_means(tmeans, jmeans, what, val_tokens):
    assert set(tmeans) == set(jmeans), what
    for k, jv in jmeans.items():
        if k == "sparsity":  # active latents per token / C: a count of switches
            switches = abs(tmeans[k] - jv) * C_OF[what.split("->")[0]] * val_tokens
            assert switches <= MAX_SWITCHES + 1e-6, (what, switches)
        elif k in ("perc_same", "perc_dead_units", "accuracy"):
            assert tmeans[k] == pytest.approx(jv, abs=1e-6), (what, k)
        elif k in ("loss_diff", "kld"):
            np.testing.assert_allclose(tmeans[k], jv, atol=1e-5, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(tmeans[k], jv, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{what} {k}")


def _exported(paths_mod, cfg) -> dict:
    """The run's exported .npz weights (the same file name in both packages)."""
    name = paths_mod.sae_run_name(cfg) if hasattr(paths_mod, "sae_run_name") else (
        f"{cfg.sae_layer}_" + "_".join(str(v) for v in paths_mod.sae_params_no_epochs(cfg).values()))
    path = os.path.join(paths_mod.folder_paths(cfg)["sae_weights"], f"{name}_model_weights.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _check_params(runs, jcfg, tcfg, what):
    jp, tp = _exported(j_paths, jcfg), _exported(t_paths, tcfg)
    assert set(jp) == set(tp) == {"W_enc", "b_enc", "W_dec", "b_dec"}, what
    for k, v in jp.items():
        assert tp[k].shape == v.shape, (what, k)
        np.testing.assert_allclose(tp[k], v, rtol=2e-3, atol=2e-5, err_msg=f"{what} {k}")


def test_each_package_dumps_every_layer_in_one_pass(runs):
    """One dump_activations_multi call for the SAEs (the three layers) and one
    for the transcoders (their own cache folder, the same three layers) in
    each package, and no single-layer dump."""
    for calls in (*runs["sae_dumps"], *runs["tc_dumps"]):
        assert calls == [list(LAYERS)]


def test_sae_eval_means_and_final_weights_match_jax(runs):
    assert list(runs["t_sae"]) == list(runs["j_sae"]) == list(LAYERS)
    for layer in LAYERS:
        _check_means(runs["t_sae"][layer], runs["j_sae"][layer], layer, VAL_TOKENS)
        _check_params(runs, j_ml.layer_config(runs["jbase"], layer),
                      t_ml.layer_config(runs["tbase"], layer), layer)


def test_mixed4d_trains_at_its_registry_width_through_the_padded_op(runs):
    """mixed4d's SAE has 528 x 4 = 2,112 latents, no multiple of 128: the port's
    fused op takes it (padded), its weights keep H = 2,112, and it learns."""
    cfg = t_ml.layer_config(runs["tbase"], "mixed4d")
    assert cfg.use_pallas
    from sparse_vision_tpu_torch.ops import fused_sae

    assert fused_sae.can_fuse(128, 2112, 528, "bfloat16")
    assert fused_sae.padded_h(2112) == 2176
    tp = _exported(t_paths, cfg)
    assert tp["W_enc"].shape == (528, 2112) and tp["W_dec"].shape == (2112, 528)
    m = runs["t_sae"]["mixed4d"]
    assert np.isfinite(list(m.values())).all() and m["perc_dead_units"] < 1


def test_transcoder_eval_means_and_final_weights_match_jax(runs):
    assert list(runs["t_tc"]) == list(runs["j_tc"]) == list(PAIRS)
    for a, b in PAIRS:
        _check_means(runs["t_tc"][(a, b)], runs["j_tc"][(a, b)], f"{a}->{b}", VAL_TOKENS)
        jcfg = dataclasses.replace(j_ml.layer_config(runs["jbase"], a),
                                   sae_model_name="transcoder", transcoder_target_layer=b)
        _check_params(runs, jcfg, t_ml.pair_config(runs["tbase"], a, b), f"{a}->{b}")


def test_a_rerun_dumps_nothing(runs, monkeypatch):
    """With every cache in place a second call of either package dumps nothing
    (Pipeline.run replaced: only the dump decision is under test here)."""
    jdump, tdump, kwargs = _patch(monkeypatch)
    monkeypatch.setattr(j_pipeline.Pipeline, "run", lambda self: {})
    monkeypatch.setattr(t_pipeline.Pipeline, "run", lambda self: {})
    j_ml.train_saes_multilayer(runs["jbase"], layers=list(LAYERS))
    t_ml.train_saes_multilayer(runs["tbase"], layers=list(LAYERS), **kwargs)
    j_ml.train_transcoders_multilayer(runs["jbase"], pairs=list(PAIRS))
    t_ml.train_transcoders_multilayer(runs["tbase"], pairs=list(PAIRS), **kwargs)
    assert jdump.calls == tdump.calls == []


def test_the_cli_reruns_the_layers_to_the_same_means(runs, monkeypatch, capsys):
    """--multilayer through the port's CLI (--device cpu) on the fixture's
    folder: no dump (every cache is there), and one JSON line whose per-layer
    means equal the port's first run exactly (same caches, same weights)."""
    _, tdump, kwargs = _patch(monkeypatch)
    monkeypatch.setattr(t_pipeline, "load_data",
                        lambda cfg, class_filter=None: kwargs["datasets"])
    monkeypatch.setattr(t_pipeline, "init_backbone", lambda net, gen, name: kwargs["backbone"])
    cfg = json.loads(runs["tbase"].to_json())
    capsys.readouterr()
    out = cli.main(["--run_pipeline", "--config", json.dumps(cfg), "--device", "cpu",
                    "--multilayer", ",".join(LAYERS)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert printed["multilayer"] == ",".join(LAYERS)
    assert printed["results"] == runs["t_sae"]
    assert tdump.calls == []
    out = cli.main(["--run_pipeline", "--config", json.dumps(cfg), "--device", "cpu",
                    "--multilayer", "transcoders:" + ",".join(LAYERS)])
    assert out["results"] == {f"{a}->{b}": m for (a, b), m in runs["t_tc"].items()}
    assert tdump.calls == []


def test_transcoder_pairs_and_the_default_layers_equal_jax(monkeypatch, tmp_path):
    """Over GoogLeNet's eight CIRCUIT_LAYERS both packages pair 3a->3b,
    4b->4c->4d->4e and 5a->5b (the pool-crossing neighbours are left out),
    and with no layers given both train every circuit layer in one dump."""
    jpairs = j_ml.transcoder_pairs(j_make_backbone("inceptionv1", "imagenet"), "imagenet")
    tpairs = t_ml.transcoder_pairs(t_make_backbone("inceptionv1", "imagenet"), "imagenet")
    assert tpairs == [tuple(p) for p in jpairs] == [
        ("mixed3a", "mixed3b"), ("mixed4b", "mixed4c"), ("mixed4c", "mixed4d"),
        ("mixed4d", "mixed4e"), ("mixed5a", "mixed5b")]
    assert t_ml.transcoder_pairs(t_make_backbone("inceptionv1", "imagenet"), "imagenet",
                                 ["mixed3b", "mixed4a", "mixed4b"]) == [("mixed4a", "mixed4b")]
    jdump, tdump, kwargs = _patch(monkeypatch)
    for mod in (j_cache, t_cache):  # record the layers, write nothing
        monkeypatch.setattr(mod, "dump_activations_multi",
                            Counter(lambda *args, **kwargs: None))
    monkeypatch.setattr(j_pipeline.Pipeline, "run", lambda self: self.cfg.sae_layer)
    monkeypatch.setattr(t_pipeline.Pipeline, "run", lambda self: self.cfg.sae_layer)
    base = dict(BASE, sae_layer="mixed4a")  # no registry layer: the default is the first
    jres = j_ml.train_saes_multilayer(JConfig(**base, directory_path=str(tmp_path)))
    tres = t_ml.train_saes_multilayer(TConfig(**base, directory_path=str(tmp_path)), **kwargs)
    assert list(tres) == list(jres) == list(CIRCUIT_LAYERS)
    assert tres == jres
    assert j_cache.dump_activations_multi.calls == t_cache.dump_activations_multi.calls == [
        list(CIRCUIT_LAYERS)]
