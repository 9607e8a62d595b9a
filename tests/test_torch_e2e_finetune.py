"""The port's end-to-end KL finetune (train/e2e_finetune.py) against the JAX
package's: one finetune step of every dictionary on the same parameters
(convert.py) and images, then Pipeline.run with sae_e2e_finetune_epochs 2
(results rows, checkpoint epochs, a resume into the finetune, the
crosscoder's diffing CSV after the finetune, the rms refusal).

Small: custom_cnn_1 on 28 px single-channel images (conv2's 14 x 14 x 64 maps,
relu2 beside it at the same size), 2x expansion (128 latents), batches of 4
images (784 tokens) in the step tests. Inputs come from numpy seeds; the
backbone and the dictionaries are the JAX package's initial draws.

Tolerances, those of tests/test_torch_steps.py: the frameworks' f32
convolutions and matmuls sum in other orders (~1e-6 relative), so the step
metrics are held at rtol 2e-4 (STEP_RTOL) with atol 1e-7 for kld, a
difference of nearly equal log-probabilities (KLD_ATOL); perc_same and the
dead accumulator exactly; parameters at rtol 2e-3, atol 2e-5 (PARAMS_RTOL,
PARAMS_ATOL: Adam's first steps divide by sqrt(nu) and amplify the rounding
of tiny gradients). Through Pipeline.run the evals are held at rtol 1e-4 with
atol 1e-5 for the near-zero differences (loss_diff, kld), as
tests/test_torch_pipeline.py holds them, and the finetune's per-step metrics
at rtol 1e-3 (PIPE_STEP_RTOL: the training before it carries the ~1e-6).
The crosscoder's Pipeline trains with plain Adam, where a gradient entry below
Adam's eps turns the frameworks' f32 rounding into up to ~lr / 4 of a step
(tests/test_torch_pipeline.py's rms run): its weights and decoder norms are
held within one step, lr, with at most ADAM_OFF weights past the params
tolerance (9 of W_enc_0's 8,192 were, measured).
"""

import csv
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.models import backbone as j_backbone
from sparse_vision_tpu.models import crosscoder as j_cc
from sparse_vision_tpu.models import sae as j_sae
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.train import e2e_finetune as j_ft
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.models import backbone as t_backbone
from sparse_vision_tpu_torch.models.crosscoder import crosscoder_decoder_norms
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.train import checkpoint as t_ckpt
from sparse_vision_tpu_torch.train import e2e_finetune as t_ft
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from sparse_vision_tpu_torch.train.pipeline import _SLICE, validate_slice
from sparse_vision_tpu_torch.train.sae_io import load_sae_weights
from sparse_vision_tpu_torch.train.steps import init_sae_train_state as t_init
from test_torch_pipeline import _Recorder, quick_jax_pipeline

NET, DATASET, SIZE = "custom_cnn_1", "mnist", (28, 28, 1)
LAYER, NEXT, C, K = "conv2", "relu2", 64, 2
H = C * K
B, STEPS, LAMBDA, ALPHA, LR = 4, 2, 0.5, 0.5, 1e-3
STEP_RTOL, KLD_ATOL = 2e-4, 1e-7
PARAMS_RTOL, PARAMS_ATOL = 2e-3, 2e-5
PIPE_RTOL, PIPE_ATOL, PIPE_STEP_RTOL = 1e-4, 1e-5, 1e-3
# the plain-Adam crosscoder run: every weight within one Adam step (lr) of
# JAX's, at most ADAM_OFF past the params tolerance (docstring)
ADAM_OFF = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def backbone():
    jnet = j_backbone.make_backbone(NET, DATASET)
    jparams, jstate = jax.jit(lambda k: j_backbone.init_backbone(jnet, k, DATASET))(
        jax.random.key(0))
    tparams, tstate = convert.backbone_from_jax(*jax.device_get((jparams, jstate)))
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B,) + SIZE).astype(np.float32),
                rng.integers(0, 10, size=B).astype(np.int32)) for _ in range(STEPS)]
    return jnet, jparams, jstate, t_backbone.make_backbone(NET, DATASET), tparams, tstate, \
        batches


# dictionary -> (its JAX init, its optimizer)
DICTS = {
    "sae_mlp": (lambda k: j_sae.init_sae("sae_mlp", k, C, K), "constrained_adam"),
    "gated_sae": (lambda k: j_sae.init_sae("gated_sae", k, C, K), "constrained_adam"),
    "jumprelu_sae": (lambda k: j_sae.init_sae("jumprelu_sae", k, C, K,
                                              jumprelu_threshold_init=0.05),
                     "constrained_adam"),
    "matryoshka_sae": (lambda k: j_sae.init_sae("matryoshka_sae", k, C, K),
                       "constrained_adam"),
    "topk_sae": (lambda k: j_sae.init_sae("topk_sae", k, C, K), "constrained_adam"),
    "batch_topk_sae": (lambda k: j_sae.init_sae("batch_topk_sae", k, C, K),
                       "constrained_adam"),
    "transcoder": (lambda k: j_sae.init_transcoder(k, C, K, C), "constrained_adam"),
    "crosscoder": (lambda k: j_cc.init_crosscoder(k, (C, C), K), "adam"),
}


def _steps(name: str, jnet, tnet, jtx, ttx):
    """The JAX and the port's finetune steps of ``name`` (λ LAMBDA, alpha_mse
    ALPHA; the TopK family at k 8, JumpReLU at bandwidth 0.05)."""
    if name == "transcoder":
        return (j_ft.make_transcoder_e2e_finetune_step(jnet, LAYER, NEXT, LAMBDA, jtx, ALPHA),
                t_ft.make_transcoder_e2e_finetune_step(tnet, LAYER, NEXT, LAMBDA, ttx, ALPHA))
    if name == "crosscoder":
        return (j_ft.make_crosscoder_e2e_finetune_step(jnet, (LAYER, NEXT), LAMBDA, jtx, ALPHA),
                t_ft.make_crosscoder_e2e_finetune_step(tnet, (LAYER, NEXT), LAMBDA, ttx,
                                                       ALPHA))
    kw = dict(alpha_mse=ALPHA, topk=8, jumprelu_bandwidth=0.05)
    return (j_ft.make_sae_e2e_finetune_step(jnet, LAYER, name, LAMBDA, jtx, **kw),
            t_ft.make_sae_e2e_finetune_step(tnet, LAYER, name, LAMBDA, ttx, **kw))


@pytest.mark.parametrize("name", list(DICTS))
def test_finetune_steps_match_jax(name, backbone):
    """Two finetune steps from the same parameters and a fresh optimizer state:
    the metrics of each step (JAX's names), the dead accumulator, and the
    parameters after them (batch_topk's threshold by its EMA)."""
    jnet, jparams, jstate, tnet, tparams, tstate, batches = backbone
    init, opt = DICTS[name]
    params = jax.device_get(init(jax.random.key(1)))
    jtx, ttx = joptim.get_optimizer(opt, LR), toptim.get_optimizer(opt, LR)
    jts = j_init(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    tts = t_init(convert.sae_params_from_jax(params), ttx, H, seed=0)
    jstep, tstep = _steps(name, jnet, tnet, jtx, ttx)
    for i, (x, y) in enumerate(batches, start=1):
        jts, jm = jstep(jts, jparams, jstate, jnp.asarray(x), jnp.asarray(y))
        tts, tm = tstep(tts, tparams, tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert set(tm) == set(jm) == {"e2e_loss", "kld", "sae_rec_loss", "sae_l1_loss",
                                      "perc_same", "sparsity"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_RTOL,
                                       atol=KLD_ATOL if k == "kld" else 0,
                                       err_msg=f"{name} step {i} {k}")
        assert float(tm["perc_same"]) == float(jm["perc_same"])
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
    assert tts.step == int(jts.step) == STEPS
    assert float(jm["kld"]) > 0  # the splice moves the logits: a KL gradient flows
    for k, v in jts.params.items():
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(v), rtol=PARAMS_RTOL,
                                   atol=PARAMS_ATOL, err_msg=f"{name} {k}")
        assert not np.array_equal(np.asarray(v), params[k]) or k in ("threshold",), k


def test_finetune_gradient_reaches_the_dictionary_only(backbone):
    """The backbone's parameters and statistics come out of a step untouched,
    and its logits carry no graph (the frozen model, in eval mode)."""
    _, _, _, tnet, tparams, tstate, batches = backbone
    before = {k: {n: v.clone() for n, v in p.items()} if isinstance(p, dict) else p
              for k, p in tparams.items()}
    params = convert.sae_params_from_jax(jax.device_get(
        j_sae.init_sae("sae_mlp", jax.random.key(1), C, K)))
    tx = toptim.get_optimizer("constrained_adam", LR)
    step = t_ft.make_sae_e2e_finetune_step(tnet, LAYER, "sae_mlp", LAMBDA, tx)
    x, y = batches[0]
    ts, _ = step(t_init(params, tx, H), tparams, tstate, torch.from_numpy(x),
                 torch.from_numpy(y))
    for k, p in tparams.items():
        for n, v in (p.items() if isinstance(p, dict) else ()):
            assert not v.requires_grad and torch.equal(v, before[k][n]), (k, n)
    # ConstrainedAdam kept the decoder rows at unit norm
    norms = torch.linalg.vector_norm(ts.params["W_dec"], dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Pipeline.run with sae_e2e_finetune_epochs
# ---------------------------------------------------------------------------

CFG = dict(model_name=NET, dataset_name=DATASET, sae_layer=LAYER, sae_model_name="sae_mlp",
           sae_expansion_factor=K, sae_lambda_sparse=LAMBDA, sae_optimizer_name="constrained_adam",
           sae_learning_rate=LR, sae_batch_size=16, use_activation_cache=True,
           cache_tokens_per_step=784, cache_dtype="float32", compute_dtype="float32",
           sae_epochs=1, dead_neurons_steps=1000, seed=3, sae_e2e_finetune_epochs=2,
           sae_e2e_alpha_mse=ALPHA, log_every=10**9)


def _datasets(make):
    tr = make(num_samples=64, img_size=SIZE, num_classes=10, seed=3)
    va = make(num_samples=32, img_size=SIZE, num_classes=10, seed=4)
    return tr, va, tr.category_names, SIZE


def _run_both(cfg: dict, tmp_path_factory) -> dict:
    jcfg = JConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("jax")))
    rec = _Recorder()
    with quick_jax_pipeline():
        jpipe = JPipeline(jcfg, logger=rec, datasets=_datasets(j_synth))
        backbone = convert.backbone_from_jax(*jax.device_get((jpipe.frozen_params,
                                                              jpipe.net_state)))
        sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
        jpipe.CACHE_SCAN_K = 2
        jmeans = jpipe.run()
    tcfg = TConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("torch")))
    tpipe = TPipeline(tcfg, device="cpu", datasets=_datasets(t_synth), backbone=backbone,
                      sae_params=sae)
    tpipe.CACHE_SCAN_K = 2
    tmeans = tpipe.run()
    return dict(jpipe=jpipe, rec=rec, jmeans=jmeans, tpipe=tpipe, tmeans=tmeans,
                backbone=backbone, sae=sae)


@pytest.fixture(scope="module")
def sae_run(tmp_path_factory):
    return _run_both(CFG, tmp_path_factory)


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        if want[k] is None or isinstance(want[k], str):
            assert got[k] == want[k], (what, k)
            continue
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=PIPE_RTOL,
                                   atol=PIPE_ATOL, err_msg=f"{what} {k}")


def test_pipeline_finetune_matches_jax(sae_run):
    """The finetune's steps (JAX's logger gets each one), the last eval's means
    and the final parameters."""
    jpipe, tpipe, rec = sae_run["jpipe"], sae_run["tpipe"], sae_run["rec"]
    train_steps = 16  # 64 images x 196 tokens / 784 a step
    ft_steps = 2 * 4  # two epochs of 64 images in batches of 16
    assert tpipe.ts.step == int(jpipe.ts.step) == train_steps + ft_steps
    assert [s for s, _ in tpipe.finetune_log] == list(range(train_steps + 1,
                                                            train_steps + ft_steps + 1))
    for s, m in tpipe.finetune_log:
        want = rec.train[s]
        assert set(m) == set(want)
        for k in want:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=PIPE_STEP_RTOL,
                                       atol=KLD_ATOL if k == "kld" else 0,
                                       err_msg=f"finetune step {s} {k}")
    _close(sae_run["tmeans"], sae_run["jmeans"], "last eval")
    for k, v in jpipe.ts.params.items():
        np.testing.assert_allclose(tpipe.ts.params[k].numpy(), np.asarray(v), rtol=PARAMS_RTOL,
                                   atol=PARAMS_ATOL, err_msg=k)
    assert [t["epoch"] for t in tpipe.finetune_timing] == [1, 2]
    assert sum(t["images"] for t in tpipe.finetune_timing) == 128


def test_pipeline_results_rows_and_checkpoints_match_jax(sae_run):
    """One results row per epoch, the finetune's numbered on (epochs 1, 2, 3),
    checkpoints of the same epochs, and the export of the finetuned weights."""
    jpipe, tpipe = sae_run["jpipe"], sae_run["tpipe"]
    for e in (1, 2, 3):
        name = f"{tpipe.run_id}_epoch_{e}.json"
        with open(os.path.join(jpipe.paths["evaluation_results"], name)) as f:
            jrow = json.load(f)
        with open(os.path.join(tpipe.paths["evaluation_results"], name)) as f:
            trow = json.load(f)
        _close(trow, jrow, f"row {e}")
    jdir, tdir = jpipe._sae_ckpt_dir(), tpipe._sae_ckpt_dir()
    assert sorted(os.listdir(jdir)) == ["epoch_1", "epoch_2", "epoch_3"]
    assert sorted(os.listdir(tdir)) == ["epoch_1", "epoch_2", "epoch_3"]
    assert t_ckpt.latest_epoch(tdir) == 3
    folder = tpipe.paths["sae_weights"]
    (npz,) = [f for f in os.listdir(folder) if f.endswith(".npz")]
    exported = load_sae_weights(os.path.join(folder, npz))
    for k, v in tpipe.ts.params.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), v.numpy(), err_msg=k)


def test_resume_into_the_finetune_runs_only_the_remainder(sae_run, tmp_path):
    """A run resumed from the checkpoint of epoch 2 (MSE epoch 1, finetune
    epoch 1) runs the second finetune epoch only, numbered 3, and ends where
    the uninterrupted run ended, bitwise."""
    tpipe = sae_run["tpipe"]
    folder = tmp_path / "resumed"
    shutil.copytree(tpipe.cfg.directory_path, folder)
    cfg = dataclasses.replace(tpipe.cfg, directory_path=str(folder), sae_checkpoint_epoch=2)
    resumed = TPipeline(cfg, device="cpu", datasets=_datasets(t_synth),
                        backbone=sae_run["backbone"], sae_params=sae_run["sae"])
    resumed.CACHE_SCAN_K = 2
    resumed.run()
    assert resumed.train_log == [] and resumed.train_timing == []
    assert [s for s, _ in resumed.finetune_log] == [21, 22, 23, 24]
    assert [t["epoch"] for t in resumed.finetune_timing] == [2]
    assert [e for e, _ in resumed.eval_log] == [2, 3]
    for k, v in tpipe.ts.params.items():
        assert torch.equal(resumed.ts.params[k], v), k


def test_crosscoder_diffing_csv_reads_the_finetuned_parameters(tmp_path_factory):
    cfg = {**CFG, "sae_model_name": "crosscoder", "crosscoder_layers": NEXT,
           "sae_optimizer_name": "adam", "cache_tokens_per_step": 392,
           "sae_e2e_finetune_epochs": 1, "sae_lambda_sparse": 0.05}
    run = _run_both(cfg, tmp_path_factory)
    jpipe, tpipe = run["jpipe"], run["tpipe"]
    assert tpipe.ts.step == int(jpipe.ts.step) == 32 + 4  # 12,544 tokens / 392, then 64 / 16
    off = 0
    for k, v in jpipe.ts.params.items():
        got, want = tpipe.ts.params[k].numpy(), np.asarray(v)
        np.testing.assert_allclose(got, want, rtol=0, atol=LR, err_msg=k)
        off += int((np.abs(got - want) > PARAMS_ATOL + PARAMS_RTOL * np.abs(want)).sum())
    assert off <= ADAM_OFF, f"{off} weights past rtol {PARAMS_RTOL} / atol {PARAMS_ATOL}"
    name = os.path.basename(tpipe.decoder_norms_path)
    with open(tpipe.decoder_norms_path) as f:
        trows = list(csv.DictReader(f))
    with open(os.path.join(jpipe.paths["sae_weights"], name)) as f:
        jrows = list(csv.DictReader(f))
    assert len(trows) == len(jrows) == tpipe.num_units
    got = np.array([[float(v) for v in r.values()] for r in trows])
    want = np.array([[float(v) for v in r.values()] for r in jrows])
    np.testing.assert_allclose(got, want, rtol=0, atol=LR)
    # the CSV holds the parameters after the finetune, not those of epoch 1
    norms = crosscoder_decoder_norms(tpipe.ts.params).numpy()
    np.testing.assert_array_equal(got[:, 1:3].T.astype(np.float32), norms)


def test_rms_refuses_the_finetune_as_in_jax(tmp_path):
    cfg = {**CFG, "sae_input_norm": "rms"}
    with pytest.raises(ValueError, match="e2e KL"):
        JPipeline(JConfig(**cfg, directory_path=str(tmp_path / "j")),
                  datasets=_datasets(j_synth))
    with pytest.raises(ValueError, match="e2e KL"):
        TPipeline(TConfig(**cfg, directory_path=str(tmp_path / "t")), device="cpu",
                  datasets=_datasets(t_synth))


def test_finetune_epochs_and_profile_dir_pass_validate_slice(tmp_path):
    validate_slice(TConfig(**CFG, profile_dir=str(tmp_path)))
    assert "wandb_status" in _SLICE and "mesh_shape" not in _SLICE
    assert "sae_e2e_finetune_epochs" not in _SLICE and "profile_dir" not in _SLICE
