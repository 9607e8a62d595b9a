"""The port's crosscoder (models/crosscoder.py, its resample, train/crosscoder.py
and the decoder-norm diffing CSV) against the JAX package: JAX-initialized
parameters carried over with convert.py (the flat per-layer layout needs no
mapping), inputs made with numpy from a seed, the JAX package's resample draws
injected. Layers of 8, 12 and 20 channels.

Tolerances: model outputs, loss terms and decoder norms rtol 1e-5 (f32 on both
sides); resample rtol 1e-5, atol 1e-7 (tests/test_torch_resample.py);
trajectories as tests/test_torch_steps.py (losses rtol 2e-4, final params rtol
2e-3, atol 2e-5, dead accumulators equal); CSV values rtol 1e-6. The eval step
runs in tests/test_torch_pipeline.py.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from sparse_vision_tpu.models import crosscoder as jcc
from sparse_vision_tpu.models.sae import kaiming_uniform
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.resample import resample_dead_neurons_crosscoder as j_resample
from sparse_vision_tpu.train.crosscoder import make_crosscoder_train_step_from_acts as j_make
from sparse_vision_tpu.train.crosscoder import save_decoder_norms as j_save
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init_ts
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import crosscoder as tcc
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.ops import resample as tres
from sparse_vision_tpu_torch.train import crosscoder as ttrain
from sparse_vision_tpu_torch.train import steps as tsteps

DIMS, EF = (8, 12, 20), 8
H = DIMS[0] * EF
T, N, STEPS, LAMBDA, LR = 64, 3, 9, 0.5, 1e-3
LAYERS = ("mixed4a", "mixed4b", "mixed4c")


def _jax_params(seed=0):
    return jax.device_get(jcc.init_crosscoder(jax.random.key(seed), DIMS, EF))


def test_init_crosscoder_layout():
    p = tcc.init_crosscoder(torch.Generator().manual_seed(0), DIMS, EF)
    assert tcc.crosscoder_num_layers(p) == 3
    for i, d in enumerate(DIMS):
        assert p[f"W_enc_{i}"].shape == (d, H) and p[f"W_dec_{i}"].shape == (H, d)
        assert float(p[f"W_enc_{i}"].abs().max()) <= (6.0 / d) ** 0.5 / 3
    # rows at norm 1/L, so n_j = 1 at init
    np.testing.assert_allclose(tcc.crosscoder_decoder_norms(p).sum(0).numpy(), 1.0, rtol=1e-6)


def test_flat_params_convert_unchanged():
    jp = _jax_params()
    tp = convert.sae_params_from_jax(jp)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)


def test_apply_loss_terms_and_decoder_norms_match_jax():
    jp = _jax_params()
    jp["b_enc"] = jp["b_enc"] - 0.02
    rng = np.random.default_rng(0)
    for i, d in enumerate(DIMS):
        jp[f"b_dec_{i}"] = (0.1 * rng.normal(size=d)).astype(np.float32)
    tp = convert.sae_params_from_jax(jp)
    acts = [rng.normal(size=(2, 4, 4, d)).astype(np.float32) for d in DIMS]  # NHWC taps
    jout = jcc.crosscoder_inference_and_loss(jp, tuple(jnp.asarray(a) for a in acts), LAMBDA)
    tout = tcc.crosscoder_inference_and_loss(tp, tuple(torch.from_numpy(a) for a in acts),
                                             LAMBDA)
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5, err_msg=k)
    for k in ("encoded", "encoded_pre"):
        assert tuple(tout[k].shape) == jout[k].shape == (2, 4, 4, H)
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-5, atol=1e-6)
    for a, b in zip(tout["decoded"], jout["decoded"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcc.crosscoder_decoder_norms(tp).numpy(),
                               np.asarray(jcc.crosscoder_decoder_norms(jp)), rtol=1e-5)


def test_token_count_mismatch_raises():
    p = tcc.init_crosscoder(torch.Generator().manual_seed(0), (4, 6), 2)
    with pytest.raises(ValueError, match="token count"):
        tcc.crosscoder_inference_and_loss(p, (torch.zeros(2, 3, 4), torch.zeros(2, 2, 6)), 0.1)


def _jax_draws(key):
    """The draws jax resample_dead_neurons_crosscoder makes from ``key``
    (resample.py:237-267): 2 keys a layer, encoder [h, d] then decoder [d, h]."""
    keys = jax.random.split(key, 2 * len(DIMS))
    return [(torch.from_numpy(np.array(kaiming_uniform(keys[2 * i], (H, d), fan_in=d))),
             torch.from_numpy(np.array(kaiming_uniform(keys[2 * i + 1], (d, H), fan_in=H))))
            for i, d in enumerate(DIMS)]


@pytest.mark.parametrize("dead_kind", ["some", "none", "all"])
def test_resample_matches_jax(dead_kind):
    params = jax.tree.map(jnp.asarray, _jax_params())
    rng = np.random.default_rng(0)
    params["b_enc"] = jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.1)
    tx = joptim.get_optimizer("adam", 1e-3)
    state = tx.init(params)
    for _ in range(3):  # non-zero moments, decoder norms away from 1/L
        g = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
             for k, v in params.items()}
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    dead = {"some": rng.random(H) < 0.3, "none": np.zeros(H, bool),
            "all": np.ones(H, bool)}[dead_kind]
    key = jax.random.key(7)
    jp, js = j_resample(params, state, jnp.asarray(dead), key)
    adam = state[0]
    tp = convert.sae_params_from_jax(jax.device_get(params))
    ts = convert.adam_state_from_jax(jax.device_get(adam.mu), jax.device_get(adam.nu),
                                     adam.count)
    tp2, ts2 = tres.resample_dead_neurons_crosscoder(tp, ts, torch.from_numpy(dead),
                                                     _jax_draws(key))
    for k in tp:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(ts2[m][k].numpy(), np.asarray(getattr(js[0], m)[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{m} {k}")
    assert ts2["count"] == int(js[0].count) == 3
    if dead_kind == "some":  # no final renorm: live rows keep their norms
        live = ~dead
        for i in range(len(DIMS)):
            np.testing.assert_array_equal(tp2[f"W_dec_{i}"].numpy()[live],
                                          tp[f"W_dec_{i}"].numpy()[live])


def _jax_step_draws(step: int, seed: int = 0):
    """The draws the JAX crosscoder step makes at 1-based ``step``."""
    key = jax.random.key(seed)
    for _ in range(step):
        key, sub = jax.random.split(key)
    return _jax_draws(sub)


def _batches(seed=0, n=STEPS):
    rng = np.random.default_rng(seed)
    return [tuple(rng.normal(size=(T, d)).astype(np.float32) for d in DIMS) for _ in range(n)]


@pytest.mark.parametrize("fused", [True, False])
def test_trajectory_matches_jax_across_reset_and_resample(fused):
    params = _jax_params()
    params["b_enc"] = np.where(np.arange(H) < 8, -100.0, -0.02).astype(np.float32)  # 8 dead
    jtx = joptim.get_optimizer("adam", LR)
    jts = j_init_ts(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    jopts = dict(tile_t=32, tile_h=128, compute_dtype=jnp.float32, interpret=True)
    jstep = j_make(LAMBDA, jtx, N, EF, fused=fused, fused_opts=jopts if fused else None)
    ttx = toptim.get_optimizer("adam", LR)
    tts = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), ttx, H, seed=0)
    tstep = ttrain.make_crosscoder_train_step_from_acts(
        LAMBDA, ttx, N, EF, fused=fused, fused_opts={"compute_dtype": "float32"})
    resample_at = 2 * N + 1
    jl, tl = [], []
    for i, xs in enumerate(_batches(), start=1):
        jts, jm = jstep(jts, tuple(jnp.asarray(x) for x in xs))
        draws = _jax_step_draws(i) if i == resample_at else None
        tts, tm = tstep(tts, tuple(torch.from_numpy(x) for x in xs), resample_draws=draws)
        jl.append(float(jm["sae_loss"]))
        tl.append(float(tm["sae_loss"]))
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc),
                                      err_msg=f"dead_acc at step {i}")
        np.testing.assert_allclose(float(tm["sparsity"]), float(jm["sparsity"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["sae_l1_loss"]), float(jm["sae_l1_loss"]),
                                   rtol=2e-4)
        if i in (N, resample_at):
            assert float(tm["perc_dead"]) == 1.0
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    for k in params:
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=f"final {k}")
    assert float(tts.params["b_enc"][:8].min()) > -1.0  # the resample revived them


def test_multi_step_equals_single_steps():
    params = convert.sae_params_from_jax(_jax_params(1))
    batches = _batches(1, 3)
    stacks = tuple(torch.from_numpy(np.stack([b[i] for b in batches])) for i in range(3))
    tx = toptim.get_optimizer("adam", LR)
    step = ttrain.make_crosscoder_train_step_from_acts(LAMBDA, tx, 100, EF, fused=True,
                                                       fused_opts={"compute_dtype": "float32"})
    ts_a = tsteps.init_sae_train_state(params, tx, H)
    ts_b = tsteps.init_sae_train_state(params, tx, H)
    ts_a, ms = ttrain.make_crosscoder_multi_step(step)(ts_a, stacks)
    losses = []
    for xs in zip(*stacks):
        ts_b, m = step(ts_b, xs)
        losses.append(float(m["sae_loss"]))
    np.testing.assert_array_equal(ms["sae_loss"].numpy(), np.array(losses, np.float32))
    for k in params:
        np.testing.assert_array_equal(ts_a.params[k].numpy(), ts_b.params[k].numpy())


def test_decoder_norms_csv_matches_jax(tmp_path):
    """The port writes the JAX save_decoder_norms' columns, in its order, with
    the same values, one row per latent, without pandas."""
    jp = jax.tree.map(jnp.asarray, _jax_params())
    rng = np.random.default_rng(3)
    for i in range(len(DIMS)):  # uneven norms, and one latent dead in layer 0
        jp[f"W_dec_{i}"] = jp[f"W_dec_{i}"] * jnp.asarray(
            rng.uniform(0.1, 2.0, size=(H, 1)).astype(np.float32))
    jp["W_dec_0"] = jp["W_dec_0"].at[5].set(0.0)
    jpath = j_save(jax.device_get(jp), LAYERS, str(tmp_path / "jax"), "run")
    tpath = ttrain.save_decoder_norms(convert.sae_params_from_jax(jax.device_get(jp)), LAYERS,
                                      str(tmp_path / "torch"), "run")
    assert tpath.endswith("run_decoder_norms.csv")
    jdf = pd.read_csv(jpath)
    with open(tpath, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == list(jdf.columns)
    assert [f"norm_{l}" for l in LAYERS] == rows[0][1:4]
    got = np.array(rows[1:], dtype=np.float64)
    assert got.shape == jdf.shape == (H, 1 + 2 * len(LAYERS))
    np.testing.assert_array_equal(got[:, 0], np.arange(H))
    np.testing.assert_allclose(got[:, 1:], jdf.to_numpy()[:, 1:], rtol=1e-6, atol=0)
