"""sae_input_norm="rms" in the port (mirrors tests/test_input_norm.py): the
dictionary trains on each layer's activations divided by its cache's token RMS,
and the eval splice rescales the reconstruction back, so KLD, %same and
loss_diff stay those of the raw model. Held here: token_rms recorded at the dump
and computed lazily (against numpy); the eval splice exact with an identity
dictionary, and the scaled eval step against the JAX one on the same weights and
images (rtol 1e-5: the backbones' f32 convolutions round differently, ~1e-6);
the scaled train step invariant to the activations' scale; and the config
guards, which refuse before any dump. The pipeline runs at rms are in
tests/test_torch_pipeline.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu.train.steps import make_sae_eval_step as j_eval_step
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.activation_cache import ActivationCache, _ShardWriter
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.train import steps as tsteps
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

SIZE = (32, 32, 3)
CFG = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
           sae_model_name="sae_mlp", sae_expansion_factor=1, sae_lambda_sparse=0.1,
           sae_batch_size=16, use_activation_cache=True, cache_tokens_per_step=128,
           cache_dtype="float32", compute_dtype="float32", sae_epochs=1, seed=3)


def _datasets(make):
    tr = make(num_samples=32, img_size=SIZE, num_classes=1000, seed=3)
    return tr, tr, tr.category_names, SIZE


def _pipe(tmp_path, **kw):
    return TPipeline(TConfig(**{**CFG, **kw}, directory_path=str(tmp_path)), device="cpu",
                     datasets=_datasets(t_synth))


def test_token_rms_recorded_and_lazy(tmp_path):
    """The dump records token_rms in meta.json; a cache without the field
    computes it from the first shard and persists it."""
    rng = np.random.default_rng(0)
    data = rng.normal(0, 3.0, (200, 16)).astype(np.float32)
    w = _ShardWriter(str(tmp_path), shard_tokens=64)
    w.add(torch.from_numpy(data))
    meta = w.finish("fc1")
    assert abs(meta["token_rms"] - float(np.sqrt(np.mean(data ** 2)))) < 1e-5
    mp = tmp_path / "meta.json"
    m = json.loads(mp.read_text())
    del m["token_rms"]
    mp.write_text(json.dumps(m))
    assert abs(ActivationCache(str(tmp_path)).token_rms
               - float(np.sqrt(np.mean(data[:64] ** 2)))) < 1e-5
    assert "token_rms" in json.loads(mp.read_text())


def _identity(d: int) -> dict:
    return {"W_enc": torch.eye(d), "W_dec": torch.eye(d), "b_enc": torch.zeros(d),
            "b_dec": torch.zeros(d)}


def test_rms_eval_splice_rescales_exactly(tmp_path):
    """With an identity dictionary (ReLU-transparent: mixed3a is a concat of
    ReLU outputs) the rms splice reproduces the original model at any scale:
    decoded * scale inverts act / scale."""
    pipe = _pipe(tmp_path)
    step = tsteps.make_sae_eval_step(pipe.net, "mixed3a", "sae_mlp", 0.0, 1, pipe.criterion,
                                     input_scale=37.5)
    b = next(iter(pipe.val_ds.batches(8, shuffle=False)))
    m, _ = step(_identity(pipe.sae_input_size), pipe.frozen_params, pipe.net_state,
                torch.from_numpy(b.images), torch.from_numpy(b.labels))
    assert float(m["kld"]) < 1e-6, float(m["kld"])
    assert float(m["perc_same"]) == 1.0


def test_scaled_eval_step_matches_jax(tmp_path):
    """The port's eval step with input_scale against the JAX one, the JAX
    pipeline's backbone and SAE weights carried over with convert.py."""
    jcfg = JConfig(**{**CFG, "sae_expansion_factor": 2}, directory_path=str(tmp_path / "j"))
    jpipe = JPipeline(jcfg, datasets=_datasets(j_synth))
    backbone = convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                         jax.device_get(jpipe.net_state))
    params = jax.device_get(jpipe.ts.params)
    tpipe = TPipeline(TConfig(**{**CFG, "sae_expansion_factor": 2},
                              directory_path=str(tmp_path / "t")),
                      device="cpu", datasets=_datasets(t_synth), backbone=backbone)
    b = next(iter(tpipe.val_ds.batches(8, shuffle=False)))
    jstep = j_eval_step(jpipe.net, "mixed3a", "sae_mlp", 0.1, 2, jpipe.criterion,
                        input_scale=2.5)
    tstep = tsteps.make_sae_eval_step(tpipe.net, "mixed3a", "sae_mlp", 0.1, 2,
                                      tpipe.criterion, input_scale=2.5)
    jm, _ = jstep(params, jpipe.frozen_params, jpipe.net_state, jnp.asarray(b.images),
                  jnp.asarray(b.labels))
    tm, _ = tstep(convert.sae_params_from_jax(params), tpipe.frozen_params, tpipe.net_state,
                  torch.from_numpy(b.images), torch.from_numpy(b.labels))
    for k in ("sae_rec_loss", "sae_l1_loss", "sae_rmse_loss", "sae_nrmse_loss", "var_expl",
              "model_loss", "sparsity"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["perc_same"]) == float(jm["perc_same"])


def test_scaled_step_is_invariant_to_the_scale(tmp_path):
    """normalized_step on 4·x, with the cache's token_rms 4, is the unscaled
    step on x (a power of two: the multiply is exact), through the fused op."""
    pipe = _pipe(tmp_path, sae_input_norm="rms")
    cache_dir = pipe._cache_dir("mixed3a")
    w = _ShardWriter(cache_dir, shard_tokens=64)
    w.add(torch.full((64, pipe.sae_input_size), 4.0))
    assert w.finish("mixed3a")["token_rms"] == 4.0
    step = tsteps.make_sae_train_step_from_acts("sae_mlp", 0.1, pipe.tx, 100, 1, fused=True,
                                                fused_opts={"compute_dtype": "float32"})
    gen = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(128, pipe.sae_input_size, generator=gen))
    ts_a, ma = pipe.normalized_step(step, ("mixed3a",))(pipe.ts, 4.0 * x)
    ts_b, mb = step(pipe.ts, x)
    assert float(ma["sae_loss"]) == float(mb["sae_loss"])
    for k in ts_a.params:
        assert torch.equal(ts_a.params[k], ts_b.params[k]), k


def test_rms_config_guards_refuse_before_any_dump(tmp_path):
    with pytest.raises(ValueError, match="use_activation_cache"):
        _pipe(tmp_path, sae_input_norm="rms", use_activation_cache=False)
    with pytest.raises(ValueError, match="overlap_dump_train"):
        _pipe(tmp_path, sae_input_norm="rms", overlap_dump_train=True)
    with pytest.raises(ValueError, match="'none' or 'rms'"):
        _pipe(tmp_path, sae_input_norm="zscore")
    assert not os.listdir(tmp_path)  # nothing was dumped
    pipe = _pipe(tmp_path, sae_input_norm="rms")
    with pytest.raises(ValueError, match="activation cache"):
        pipe.input_scale_for("mixed3a")  # no cache yet
