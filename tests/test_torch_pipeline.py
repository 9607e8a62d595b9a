"""The slice as a whole: the JAX Pipeline and the port's Pipeline on the same
small GoogLeNet-mixed3a config and the same weights (the JAX pipeline's own,
carried over with convert.py), each dumping its own activation cache, training
from it and evaluating by splicing the SAE back into the backbone.

Small: 32 px images (mixed3a is 4 x 4 x 256), 64 train / 32 val images, 2x
expansion (512 latents), 8 steps of 128 tokens, f32 cache and compute, and
dead_neurons_steps large enough that no resample fires. Both pipelines run with
CACHE_SCAN_K = 2, so the JAX logger sees every second step. The comparisons run
for each ported variant: sae_mlp, gated_sae, jumprelu_sae and matryoshka_sae;
JumpReLU with its STE bandwidth and initial threshold scaled to these
activations (std ~0.05, the "scaled" rule of docs/CONVERGENCE.md:39), so the
thresholds train; Matryoshka with prefixes 1/4, 1/2, 1 (boundaries 128, 256,
512 latents, which both packages' kernels take; the JAX pipeline runs its stock
step on the CPU, the port its fused op's plain versions). The transcoder maps
mixed3a (256) to mixed3b (480) and splices in front of mixed3b's successor; the
crosscoder reads mixed4a..mixed4c (2 x 2 x 512 each at 32 px; 1,024 latents,
Adam, 8 steps of 32 tokens; λ = 0.02, since at λ = 1 the L1 term is ~25x the
summed MSE of these activations and nearly every latent dies), splices mixed4c, and writes its decoder-norm CSV
under the JAX package's file name. Both train from caches of every layer they
read, dumped in one backbone pass; the transcoder's caches are bf16 (the JAX
stock step on the CPU computes in f32, so both compute in f32). The crosscoder's
stay f32: under plain Adam a latent that one bf16 rounding of the caches
switches on for one token moves its weights by ~lr.

The host side of the cached path: sae_mlp and the transcoder also run with
overlap_dump_train (the dump on a thread, the first epoch streamed from its
shards in dump order), sae_mlp with an int8 cache (dequantized on the device:
the (int8 stack, scale) pairs through the quant steps), and the crosscoder with
sae_input_norm="rms" at λ = 0.5 (tests/test_input_norm.py's crosscoder λ: on the
normalized basis the code stays alive, which it checks). The rms run is held to
the JAX run on its per-step losses, eval means and decoder-norm CSV, and on its
final weights at a bound of its own (RMS_PARAMS_ATOL, RMS_PARAMS_OFF). Run step
by step from the same cache bytes, the two frameworks' pre-activations agree
bitwise on the same weights and no latent switches in the 8 steps; the weights
part at the first update. On the unit-scale basis some gradient entries cancel
to ~1e-9, below Adam's eps (1e-8), where its step lr·g/(|g| + eps) moves by up
to lr/(4·eps) = 2.5e4 per unit of g: the ~1e-10 by which the two frameworks'
f32 sums of the same gradient differ (2e-9 of the largest entry) then moves a
weight by up to ~1e-5 a step. After 8 steps a few of the 3.1 million weights
are off by up to ~8e-5, past the params tolerance below; the rest hold it.

Tolerances: the caches differ by the two frameworks' f32 convolution rounding
(~1e-6 relative, test_torch_googlenet.py), which training carries forward: losses
rtol 1e-4, eval means rtol 1e-4. Means that are differences of nearly equal
numbers (loss_diff, kld: ~1e-6 here) get atol 1e-5; counting metrics
(perc_same, perc_dead_units, accuracy) are compared exactly.

The JAX Pipelines here (and in the test files that import quick_jax_pipeline)
run faster than as shipped, in what no comparison reads: their GoogLeNet
weights come from a jitted init_backbone and their shape walk from the
stages' inits traced, not run (the eager inits compile op by op, ~20 s a
process on a CPU), and they skip the eval figures (matplotlib, and an extra
inference pass in the last epoch; ~7 s a run), which tests/test_torch_figures.py
holds the port's to.
The port's runs take the JAX Pipeline's weights, whichever init drew them.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.models import backbone as j_backbone
from sparse_vision_tpu.train import pipeline as j_pipeline
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu.utils.logging import RunLogger
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

SIZE = (32, 32, 3)
CFG = dict(
    model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
    sae_model_name="sae_mlp", sae_expansion_factor=2, sae_lambda_sparse=1.0,
    sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3, sae_batch_size=16,
    use_activation_cache=True, cache_tokens_per_step=128, cache_dtype="float32",
    compute_dtype="float32", sae_epochs=1, dead_neurons_steps=1000, seed=3,
)


# sae_model_name -> config fields beyond CFG
VARIANTS = {
    "sae_mlp": {},
    "gated_sae": {},
    "jumprelu_sae": {"jumprelu_bandwidth": 0.05, "jumprelu_threshold_init": 0.025},
    "matryoshka_sae": {"sae_matryoshka_prefixes": "0.25,0.5,1.0"},
    "transcoder": {"transcoder_target_layer": "mixed3b", "cache_dtype": "bfloat16"},
    "crosscoder": {"sae_layer": "mixed4a", "crosscoder_layers": "mixed4b,mixed4c",
                   "sae_optimizer_name": "adam", "cache_tokens_per_step": 32,
                   "sae_lambda_sparse": 0.02},
    "sae_mlp_overlap": {"sae_model_name": "sae_mlp", "overlap_dump_train": True},
    "sae_mlp_int8": {"sae_model_name": "sae_mlp", "cache_dtype": "int8"},
    "transcoder_overlap": {"sae_model_name": "transcoder", "transcoder_target_layer": "mixed3b",
                           "cache_dtype": "bfloat16", "overlap_dump_train": True},
}
# the same, for the runs held on the final weights at the bound below (docstring)
RMS_VARIANTS = {
    "crosscoder_rms": {"sae_model_name": "crosscoder", "sae_layer": "mixed4a",
                       "crosscoder_layers": "mixed4b,mixed4c", "sae_optimizer_name": "adam",
                       "cache_tokens_per_step": 32, "sae_lambda_sparse": 0.5,
                       "sae_input_norm": "rms"},
}


# every weight of the rms run within a quarter of one Adam step (lr 1e-3); at
# most RMS_PARAMS_OFF of its 3.1 million weights past the params tolerance of
# the other runs (4 were, measured)
RMS_PARAMS_ATOL = 2.5e-4
RMS_PARAMS_OFF = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_INITS: dict = {}


def _jitted_init_backbone(net, key, dataset_name):
    """init_backbone through jax.jit, once per (key, dataset, stages): the same
    arrays as the eager init, without its per-op compiles."""
    tag = (tuple(np.asarray(jax.random.key_data(key)).ravel()), dataset_name,
           tuple(net.stage_names))
    if tag not in _INITS:
        _INITS[tag] = jax.jit(lambda k: j_backbone.init_backbone(net, k, dataset_name))(key)
    return _INITS[tag]


def _traced_layer_dimensions(net, dataset_name):
    """layer_dimensions with each stage's init traced (jax.eval_shape) instead
    of run: the same shape walk, without drawing the weights."""
    shapes, s = {}, j_backbone._input_size(net, dataset_name)
    for st in net.stages:
        out = {}

        def init(k, st=st, s=s):
            params, state, out["shape"] = st.init(k, s)
            return params, state

        jax.eval_shape(init, jax.random.key(0))
        s = shapes[st.name] = tuple(out["shape"])
    return shapes


@contextlib.contextmanager
def quick_jax_pipeline():
    """The JAX Pipeline sped up (module docstring) while the block runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipeline, "init_backbone", _jitted_init_backbone)
    mp.setattr(j_backbone, "layer_dimensions", _traced_layer_dimensions)
    mp.setattr(JPipeline, "_channel_frequency_figure", lambda *a, **kw: None)
    mp.setattr(JPipeline, "_final_eval_figures", lambda *a, **kw: None)
    try:
        yield
    finally:
        mp.undo()


class _Recorder(RunLogger):
    def __init__(self):
        super().__init__("test", log_every=10**9)
        self.train = {}

    def log_train(self, step, metrics):
        self.train[step] = {k: float(v) for k, v in metrics.items()}


def _datasets(make):
    tr = make(num_samples=64, img_size=SIZE, num_classes=1000, seed=3)
    va = make(num_samples=32, img_size=SIZE, num_classes=1000, seed=4)
    return tr, va, tr.category_names, SIZE


def _run_both(cfg: dict, tmp_path_factory):
    """The JAX and the port's Pipeline on ``cfg``: (jpipe, jlog, jmeans, tpipe,
    tmeans)."""
    jcfg = JConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("jax")))
    jlog = _Recorder()
    with quick_jax_pipeline():
        jpipe = JPipeline(jcfg, logger=jlog, datasets=_datasets(j_synth))
        backbone = convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                             jax.device_get(jpipe.net_state))
        sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
        tcfg = TConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("torch")))
        tpipe = TPipeline(tcfg, device="cpu", datasets=_datasets(t_synth), backbone=backbone,
                          sae_params=sae)
        np.testing.assert_array_equal(tpipe.train_ds.images, jpipe.train_ds.images)
        jpipe.CACHE_SCAN_K = tpipe.CACHE_SCAN_K = 2
        jmeans = jpipe.train_sae()
    tmeans = tpipe.train_sae()
    return jpipe, jlog, jmeans, tpipe, tmeans


@pytest.fixture(scope="module", params=list(VARIANTS))
def runs(request, tmp_path_factory):
    return _run_both({**CFG, "sae_model_name": request.param, **VARIANTS[request.param]},
                     tmp_path_factory)


@pytest.fixture(scope="module", params=list(RMS_VARIANTS))
def rms_runs(request, tmp_path_factory):
    return _run_both({**CFG, **RMS_VARIANTS[request.param]}, tmp_path_factory)


def test_per_step_losses_match_jax(runs):
    _check_losses(runs)


def _check_losses(runs):
    _, jlog, _, tpipe, _ = runs
    tsteps = {s: {k: float(v) for k, v in m.items()} for s, m in tpipe.train_log}
    assert sorted(tsteps) == list(range(1, 9))
    assert sorted(jlog.train) == [2, 4, 6, 8]
    for s, jm in jlog.train.items():
        for k in ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"):
            np.testing.assert_allclose(tsteps[s][k], jm[k], rtol=1e-4, err_msg=f"step {s} {k}")
    assert tsteps[8]["sae_loss"] < tsteps[1]["sae_loss"]


def test_final_params_match_jax(runs):
    jpipe, _, _, tpipe, _ = runs
    assert tpipe.ts.step == int(jpipe.ts.step) == 8
    for k, v in jpipe.ts.params.items():
        np.testing.assert_allclose(tpipe.ts.params[k].numpy(), np.asarray(v), rtol=2e-3,
                                   atol=2e-5, err_msg=k)


def test_eval_means_match_jax(runs):
    _check_means(runs)


def _check_means(runs):
    _, _, jmeans, _, tmeans = runs
    assert set(tmeans) == set(jmeans)
    for k, jv in jmeans.items():
        if k in ("perc_same", "perc_dead_units", "accuracy"):
            assert tmeans[k] == pytest.approx(jv, abs=1e-6), k
        elif k in ("loss_diff", "kld"):
            np.testing.assert_allclose(tmeans[k], jv, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(tmeans[k], jv, rtol=1e-4, atol=1e-7, err_msg=k)


def test_crosscoder_writes_the_decoder_norms_csv_the_jax_run_writes(runs):
    _check_csv(runs)


def _check_csv(runs):
    jpipe, _, _, tpipe, _ = runs
    if tpipe.cfg.sae_model_name != "crosscoder":
        return
    import os

    import pandas as pd

    name = os.path.basename(tpipe.decoder_norms_path)
    jdf = pd.read_csv(os.path.join(jpipe.paths["sae_weights"], name))
    tdf = pd.read_csv(tpipe.decoder_norms_path)
    assert list(tdf.columns) == list(jdf.columns) and len(tdf) == tpipe.num_units
    np.testing.assert_allclose(tdf.to_numpy(), jdf.to_numpy(), rtol=2e-3, atol=2e-5)


def test_rms_run_matches_jax_and_keeps_its_code_alive(rms_runs):
    _check_losses(rms_runs)
    _check_means(rms_runs)
    _check_csv(rms_runs)
    _, _, jmeans, tpipe, tmeans = rms_runs
    assert tmeans["sparsity"] > 0 and tmeans["perc_dead_units"] < 0.95, tmeans
    scales = [tpipe.input_scale_for(l) for l in tpipe.crosscoder_all_layers]
    assert all(s > 0 for s in scales) and max(scales) / min(scales) > 2  # unlike scales


def test_rms_run_final_params_match_jax_within_the_adam_eps_bound(rms_runs):
    jpipe, _, _, tpipe, _ = rms_runs
    assert tpipe.ts.step == int(jpipe.ts.step) == 8
    off = 0
    for k, v in jpipe.ts.params.items():
        want, got = np.asarray(v), tpipe.ts.params[k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=RMS_PARAMS_ATOL, err_msg=k)
        off += int((np.abs(got - want) > 2e-5 + 2e-3 * np.abs(want)).sum())
    assert off <= RMS_PARAMS_OFF, f"{off} weights past rtol 2e-3 / atol 2e-5"


def test_the_port_refuses_what_the_slice_does_not_hold(tmp_path):
    base = TConfig(**CFG, directory_path=str(tmp_path))
    for field, value in [("compute_ie", "5"), ("wandb_status", True)]:
        with pytest.raises(NotImplementedError, match=field):
            TPipeline(dataclasses.replace(base, **{field: value}), device="cpu",
                      datasets=_datasets(t_synth))
    # a mesh of more than one rank needs its ranks (parallel/distributed.spawn)
    with pytest.raises(ValueError, match="spawn"):
        TPipeline(dataclasses.replace(base, mesh_shape=(2,)), device="cpu",
                  datasets=_datasets(t_synth))
    # circuit discovery runs on frozen SAEs only
    with pytest.raises(ValueError, match="not during training"):
        TPipeline(dataclasses.replace(base, compute_ie="2"), device="cpu",
                  datasets=_datasets(t_synth))
    # a target layer or extra layers only with the model that reads them
    for field, value in [("transcoder_target_layer", "mixed3b"),
                         ("crosscoder_layers", "mixed4b")]:
        with pytest.raises(NotImplementedError, match=field):
            TPipeline(dataclasses.replace(base, **{field: value}), device="cpu",
                      datasets=_datasets(t_synth))
    # crosscoders train with plain Adam; their layers go in depth order
    cc = dataclasses.replace(base, sae_model_name="crosscoder", sae_layer="mixed4a",
                             crosscoder_layers="mixed4b")
    with pytest.raises(ValueError, match="plain optimizer"):
        TPipeline(cc, device="cpu", datasets=_datasets(t_synth)).train_sae()
    with pytest.raises(ValueError, match="depth order"):
        TPipeline(dataclasses.replace(cc, crosscoder_layers="mixed3b"), device="cpu",
                  datasets=_datasets(t_synth))


def test_default_device_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPipeline(TConfig(**CFG, directory_path=str(tmp_path)), datasets=_datasets(t_synth))
