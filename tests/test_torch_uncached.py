"""SAE training without an activation cache, the JAX package's default mode:
the port's sae_conv (models/sae.py), train/steps.make_sae_train_step and
Pipeline.train_sae_uncached against the JAX package's on the same numpy inputs
and JAX-initialized weights (convert.py).

- sae_conv's apply, loss terms and gradients on small NHWC maps.
- make_sae_train_step on a tiny conv SeqNet built from the same stages in both
  packages (as tests/test_torch_circuit.py builds its nets), for every SAE
  variant: sae_mlp through the measurement reset at step 2, the others across
  two restarts of the rolling dead window, topk_sae and batch_topk_sae with
  AuxK on (batch_topk's threshold EMA among the parameters): every full metric
  of every step, the dead accumulators and the final parameters.
- One run of both Pipelines (32 px GoogLeNet, sae_mlp, 2 epochs of 4 steps of
  16 images); the port's run stops after epoch 1 and resumes from its
  checkpoint: its per-step losses, last eval means, results rows and exported
  weights against the JAX run's.

Tolerances (f32): sae_conv values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-7 (convolutions sum in another order); step metrics rtol 2e-4 with atol
1e-6 for the differences of nearly equal losses (loss_diff, kld), counting
metrics (perc_same, accuracy, perc_dead) to the rounding of their f32 means
(1e-6); params rtol 2e-3 / atol 2e-5
(tests/test_training_parity.py:114-119). The Pipelines as
tests/test_torch_pipeline.py holds its runs: losses and means rtol 1e-4,
loss_diff and kld atol 1e-5, counting metrics to 1e-6, params and exports rtol
2e-3 / atol 2e-5; per-step NRMSE rtol 1e-3 (it divides each channel's RMSE by
that channel's range in the batch, and a small range amplifies the taps' ~1e-6
convolution rounding). The JAX Pipeline is set up through
test_torch_pipeline.quick_jax_pipeline.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models import layers as jl
from sparse_vision_tpu.models import sae as jsae
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.losses import get_criterion as j_criterion
from sparse_vision_tpu.train import pipeline as j_pipeline
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu.train.steps import make_sae_train_step as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import layers as tl
from sparse_vision_tpu_torch.models import sae as tsae
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.ops.losses import get_criterion as t_criterion
from sparse_vision_tpu_torch.ops.resample import should_reset_measurement
from sparse_vision_tpu_torch.train import steps as tsteps
from test_torch_pipeline import _datasets, _Recorder, quick_jax_pipeline

COUNTING = ("perc_same", "accuracy", "perc_dead")


def close(t, j, rtol=1e-5, atol=1e-6, msg=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's work here is small: one intra-op thread is as fast alone, and
    much faster when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_params(c=6, k=2, seed=0):
    return {key: np.array(v) for key, v in jax.device_get(
        jsae.init_sae("sae_conv", jax.random.key(seed), c, k)).items()}


def test_sae_conv_apply_loss_and_grads_match_jax():
    p = _conv_params()
    act = np.random.default_rng(0).normal(size=(2, 5, 5, 6)).astype(np.float32)
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(p).items()}
    out = tsae.sae_inference_and_loss("sae_conv", tp, torch.from_numpy(act), 0.3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jout = jsae.sae_inference_and_loss("sae_conv", jp, jnp.asarray(act), 0.3)
    assert out["encoded"].shape == (2, 5, 5, 12) and out["encoded_pre"] is None
    for key in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "encoded", "decoded"):
        close(out[key], jout[key], msg=key)
    g = dict(zip(tp, torch.autograd.grad(out["loss"], list(tp.values()))))
    jg = jax.grad(lambda q: jsae.sae_inference_and_loss("sae_conv", q, jnp.asarray(act),
                                                        0.3)["loss"])(jp)
    for key in jg:
        close(g[key], jg[key], rtol=1e-4, atol=1e-7, msg=key)
    enc, dec = tsae.sae_conv_apply(tp, torch.from_numpy(act).to(torch.bfloat16))
    assert enc.dtype == dec.dtype == torch.float32  # promoted to the weights' dtype


NET = lambda m: m.SeqNet([m.conv("conv1", 5, kernel=3, padding=1), m.relu("relu1"),  # noqa: E731
                          m.conv("conv2", 6, kernel=3, padding=1), m.relu("relu2"),
                          m.flatten("flatten"), m.linear("fc", 4)])
IN_SHAPE, LAYER, C_TAP = (4, 4, 3), "relu1", 5
# variant -> (expansion, dead_neurons_steps, extra step arguments)
STEP_CASES = {"sae_mlp": (2, 2, {}), "sae_conv": (2, 2, {}),
              "topk_sae": (4, 2, {"topk": 3, "aux_k": 6}),
              "batch_topk_sae": (4, 2, {"topk": 3, "aux_k": 6}),
              "gated_sae": (2, 2, {}), "jumprelu_sae": (2, 2, {}),
              "matryoshka_sae": (4, 2, {})}
TOPK = ("topk_sae", "batch_topk_sae")


def _sae_params(name, k):
    p = {key: np.array(v) for key, v in jax.device_get(
        jsae.init_sae(name, jax.random.key(1), C_TAP, k)).items()}
    rng = np.random.default_rng(1)
    for key in ("b_enc", "b_gate", "b_mag", "b_dec"):
        if key in p:
            p[key] = (0.1 * rng.standard_normal(p[key].shape)).astype(np.float32)
    if name in TOPK:
        p["b_enc"][:4] -= 100.0  # latents that never fire: AuxK has dead ones to revive
    return p


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_uncached_train_step_matches_jax(name):
    k, window, extra = STEP_CASES[name]
    jnet, tnet = NET(jl), NET(tl)
    jparams, _ = jnet.init(jax.random.key(0), IN_SHAPE)
    tparams, _ = convert.backbone_from_jax(jax.device_get(jparams), {})
    p = _sae_params(name, k)
    h = C_TAP * k
    jtx = joptim.get_optimizer("constrained_adam", 1e-2)
    jstep = j_make(jnet, LAYER, name, 0.3, jtx, window, k, j_criterion("cross_entropy"),
                   **extra)
    jts = j_init({key: jnp.asarray(v) for key, v in p.items()}, jtx, h)
    ttx = toptim.get_optimizer("constrained_adam", 1e-2)
    tstep = tsteps.make_sae_train_step(tnet, LAYER, name, 0.3, ttx, window, k,
                                       t_criterion("cross_entropy"), **extra)
    tts = tsteps.init_sae_train_state(convert.sae_params_from_jax(p), ttx, h)
    rng = np.random.default_rng(2)
    for i in range(1, 5):
        x = rng.standard_normal((6, *IN_SHAPE)).astype(np.float32)
        y = rng.integers(0, 4, 6).astype(np.int32)
        jts, jm = jstep(jts, jparams, {}, jnp.asarray(x), jnp.asarray(y))
        tts, tm = tstep(tts, tparams, {}, torch.from_numpy(x), torch.from_numpy(y))
        assert set(tm) == set(jm) and len(jm) == 14
        for key, jv in jm.items():
            if key in COUNTING:  # a count over the batch, within its mean's rounding
                assert float(tm[key]) == pytest.approx(float(jv), abs=1e-6), (i, key)
            else:
                close(tm[key], jv, rtol=2e-4, atol=1e-6, msg=f"step {i} {key}")
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
        restart = (should_reset_measurement(i, window) if name == "sae_mlp"
                   else i % window == 0)
        assert (float(tm["perc_dead"]) == 1.0) == restart, i
        if name in TOPK:
            assert float(tm["sae_aux_loss"]) > 0
    for key in p:
        close(tts.params[key], jts.params[key], rtol=2e-3, atol=2e-5, msg=key)
        assert not np.array_equal(tts.params[key].numpy(), p[key]) or key == "b_dec", key


CFG = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
           sae_model_name="sae_mlp", sae_expansion_factor=2, sae_lambda_sparse=1.0,
           sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3, sae_batch_size=16,
           use_activation_cache=False, compute_dtype="float32", sae_epochs=2,
           dead_neurons_steps=1000, seed=3)


def _rows(folder):
    with open(os.path.join(folder, "sae_eval_results.csv")) as f:
        return {r["epochs"]: r for r in csv.DictReader(f)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from sparse_vision_tpu.config import RunConfig as JConfig
    from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
    from sparse_vision_tpu_torch.config import RunConfig as TConfig
    from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
    from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

    with quick_jax_pipeline():
        jlog = _Recorder()
        jpipe = j_pipeline.Pipeline(JConfig(**CFG, directory_path=str(
            tmp_path_factory.mktemp("jax"))), logger=jlog, datasets=_datasets(j_synth))
        sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
        jmeans = jpipe.run()
    backbone = convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                         jax.device_get(jpipe.net_state))
    tcfg = TConfig(**CFG, directory_path=str(tmp_path_factory.mktemp("torch")))
    first = TPipeline(dataclasses.replace(tcfg, sae_epochs=1), device="cpu",
                      datasets=_datasets(t_synth), backbone=backbone, sae_params=sae)
    first.run()
    resumed = TPipeline(dataclasses.replace(tcfg, sae_checkpoint_epoch=1), device="cpu",
                        datasets=_datasets(t_synth), backbone=backbone)
    tmeans = resumed.run()
    return jpipe, jlog, jmeans, first, resumed, tmeans


def test_uncached_run_per_step_losses_match_jax(runs):
    """The JAX logger sees every step of the uncached loop; the port's runs log
    steps 1-4 and, resumed from the epoch-1 checkpoint, 5-8."""
    _, jlog, _, first, resumed, _ = runs
    assert sorted(jlog.train) == list(range(1, 9))
    steps = dict(first.train_log + resumed.train_log)
    assert sorted(steps) == list(range(1, 9)) and resumed.ts.step == 8
    for s, jm in jlog.train.items():
        assert set(steps[s]) == set(jm)
        for key, jv in jm.items():
            if key in COUNTING:
                assert float(steps[s][key]) == pytest.approx(jv, abs=1e-6), (s, key)
            elif key in ("loss_diff", "kld"):
                close(steps[s][key], jv, rtol=0, atol=1e-5, msg=f"step {s} {key}")
            elif key == "sae_nrmse_loss":
                close(steps[s][key], jv, rtol=1e-3, atol=0, msg=f"step {s} {key}")
            else:
                close(steps[s][key], jv, rtol=1e-4, atol=1e-7, msg=f"step {s} {key}")
    assert steps[8]["sae_loss"] < steps[1]["sae_loss"]


def test_uncached_run_eval_means_and_results_rows_match_jax(runs):
    jpipe, _, jmeans, first, resumed, tmeans = runs
    assert set(tmeans) == set(jmeans)
    for key, jv in jmeans.items():
        if key in ("perc_same", "perc_dead_units", "accuracy"):
            assert tmeans[key] == pytest.approx(jv, abs=1e-6), key
        elif key in ("loss_diff", "kld"):
            close(tmeans[key], jv, rtol=0, atol=1e-5, msg=key)
        else:
            close(tmeans[key], jv, rtol=1e-4, atol=1e-7, msg=key)
    jrows = _rows(jpipe.paths["evaluation_results"])
    trows = _rows(resumed.paths["evaluation_results"])
    assert sorted(trows) == sorted(jrows) == ["1", "2"]
    for epoch, jr in jrows.items():
        tr = trows[epoch]
        assert list(tr) == list(jr)
        for key, jv in jr.items():
            try:
                want = float(jv)
            except ValueError:
                assert tr[key] == jv, (epoch, key)
                continue
            atol = 1e-5 if key in ("loss_diff", "perc_dead_units") else 1e-7
            close(float(tr[key]), want, rtol=1e-4, atol=atol, msg=f"{epoch} {key}")


def test_uncached_run_resumes_and_exports_the_jax_runs_weights(runs):
    jpipe, _, _, first, resumed, _ = runs
    assert resumed.ts.step == int(jpipe.ts.step) == 8
    for key, v in jpipe.ts.params.items():
        close(resumed.ts.params[key], v, rtol=2e-3, atol=2e-5, msg=key)
    folder = resumed.paths["sae_weights"]
    names = sorted(f for f in os.listdir(folder) if not f.endswith(".tmp"))
    assert names == sorted(os.listdir(jpipe.paths["sae_weights"]))
    npz = next(f for f in names if f.endswith(".npz"))
    with np.load(os.path.join(folder, npz)) as t, np.load(
            os.path.join(jpipe.paths["sae_weights"], npz)) as j:
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            close(t[key], j[key], rtol=2e-3, atol=2e-5, msg=key)
            np.testing.assert_array_equal(t[key], resumed.ts.params[key].numpy())
    # the epoch-1 run's timing: 4 steps of 16 images of 4 x 4 mixed3a tokens
    assert first.train_timing[0]["images"] == 64 and first.train_timing[0]["tokens"] == 1024


def test_sae_conv_with_a_cache_is_refused_before_any_dump(tmp_path):
    from sparse_vision_tpu_torch.config import RunConfig as TConfig
    from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
    from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

    cfg = TConfig(**{**CFG, "sae_model_name": "sae_conv", "use_activation_cache": True},
                  directory_path=str(tmp_path))
    with pytest.raises(ValueError, match="use_activation_cache"):
        TPipeline(cfg, device="cpu", datasets=_datasets(t_synth))
    assert not os.listdir(tmp_path)
    # a standalone eval of a sae_conv dictionary needs no cache
    TPipeline(dataclasses.replace(cfg, training=False), device="cpu",
              datasets=_datasets(t_synth))
