"""The port's transcoder (models/sae.py, the resample on a rectangular decoder,
train/transcoder.py) against the JAX package: JAX-initialized parameters
carried over with convert.py, inputs made with numpy from a seed, the JAX
package's resample draws injected.

Tolerances: model outputs and loss terms rtol 1e-5 (f32 on both sides);
resample rtol 1e-5, atol 1e-7 (tests/test_torch_resample.py); trajectories as
tests/test_torch_steps.py (losses rtol 2e-4, final params rtol 2e-3, atol
2e-5, dead accumulators equal). The eval step runs in tests/test_torch_pipeline.py,
whose transcoder case holds both Pipelines' eval means to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_vision_tpu.models.sae import init_transcoder as j_init_tc
from sparse_vision_tpu.models.sae import kaiming_uniform
from sparse_vision_tpu.models.sae import transcoder_apply as j_apply
from sparse_vision_tpu.models.sae import transcoder_inference_and_loss as j_loss
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.resample import resample_dead_neurons as j_resample
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init_ts
from sparse_vision_tpu.train.transcoder import make_transcoder_train_step_from_acts as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import sae as tsae
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.ops import resample as tres
from sparse_vision_tpu_torch.train import steps as tsteps
from sparse_vision_tpu_torch.train import transcoder as ttc

D_IN, EF, D_OUT = 16, 4, 24
H = D_IN * EF
T, N, STEPS, LAMBDA, LR = 64, 3, 9, 0.5, 1e-3


def test_init_transcoder_layout():
    p = tsae.init_transcoder(torch.Generator().manual_seed(0), D_IN, EF, D_OUT)
    assert p["W_enc"].shape == (D_IN, H) and p["W_dec"].shape == (H, D_OUT)
    assert p["b_enc"].shape == (H,) and p["b_dec"].shape == (D_OUT,)
    np.testing.assert_allclose(torch.linalg.vector_norm(p["W_dec"], dim=1).numpy(), 1.0,
                               rtol=1e-6)
    assert float(p["W_enc"].abs().max()) <= (6.0 / D_IN) ** 0.5


def test_apply_and_loss_terms_match_jax():
    params = jax.device_get(j_init_tc(jax.random.key(0), D_IN, EF, D_OUT))
    params["b_enc"] = params["b_enc"] - 0.05
    params["b_dec"] = params["b_dec"] + 0.1
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 4, D_IN)).astype(np.float32)  # NHWC taps
    y = rng.normal(size=(2, 4, 4, D_OUT)).astype(np.float32)
    tp = convert.sae_params_from_jax(params)
    tok = x.reshape(-1, D_IN)
    for a, b in zip(tsae.transcoder_apply(tp, torch.from_numpy(tok)),
                    j_apply(params, jnp.asarray(tok))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    jout = j_loss(params, jnp.asarray(x), jnp.asarray(y), LAMBDA)
    tout = tsae.transcoder_inference_and_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                                              LAMBDA)
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5, err_msg=k)
    for k in ("encoded", "encoded_pre", "decoded"):
        assert tuple(tout[k].shape) == jout[k].shape, k
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-5, atol=1e-6)


def test_token_count_mismatch_raises():
    p = tsae.init_transcoder(torch.Generator().manual_seed(0), 8, 2, 5)
    with pytest.raises(ValueError, match="token count"):
        tsae.transcoder_inference_and_loss(p, torch.zeros(4, 3, 8), torch.zeros(4, 2, 5), 0.1)


def _jax_draws(key, d_in, h, d_out):
    """The draws jax resample_dead_neurons makes from ``key`` (resample.py:64-88)."""
    k_enc, k_dec = jax.random.split(key)
    return (torch.from_numpy(np.array(kaiming_uniform(k_enc, (h, d_in), fan_in=d_in))),
            torch.from_numpy(np.array(kaiming_uniform(k_dec, (d_out, h), fan_in=h))))


def test_resample_with_rectangular_decoder_matches_jax():
    """resample_dead_neurons on the transcoder's [h, d_out] decoder (the JAX
    package's tests/test_transcoder.py:62): dead rows replaced, live rows kept,
    every row back at unit norm, and the same arrays as the JAX surgery."""
    params = j_init_tc(jax.random.key(0), 8, 4, 5)
    h = 32
    tx = optax.adam(1e-3)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(2):  # non-zero moments
        g = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
             for k, v in params.items()}
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    dead = np.zeros(h, bool)
    dead[[3, 7, 20]] = True
    key = jax.random.key(5)
    jp, js = j_resample(params, state, jnp.asarray(dead), key)
    adam = state[0]
    tp = convert.sae_params_from_jax(jax.device_get(params))
    ts = convert.adam_state_from_jax(jax.device_get(adam.mu), jax.device_get(adam.nu),
                                     adam.count)
    tp2, ts2 = tres.resample_dead_neurons(tp, ts, torch.from_numpy(dead),
                                          *_jax_draws(key, 8, h, 5))
    for k in tp:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_allclose(ts2["mu"][k].numpy(), np.asarray(js[0].mu[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"mu {k}")
    after = tp2["W_dec"].numpy()
    assert after.shape == (h, 5)
    np.testing.assert_allclose(np.linalg.norm(after, axis=1), 1.0, atol=1e-5)
    assert not np.allclose(after[3], tp["W_dec"][3].numpy())
    np.testing.assert_allclose(after[0], tp["W_dec"][0].numpy() / np.linalg.norm(
        tp["W_dec"][0].numpy()), atol=1e-6)


def _jax_step_draws(step: int, seed: int = 0):
    """The draws the JAX transcoder step makes at 1-based ``step``: one rng split
    a step, and the resample splits the sub-key into (enc, dec)."""
    key = jax.random.key(seed)
    for _ in range(step):
        key, sub = jax.random.split(key)
    return _jax_draws(sub, D_IN, H, D_OUT)


@pytest.mark.parametrize("fused", [True, False])
def test_trajectory_matches_jax_across_reset_and_resample(fused):
    params = jax.device_get(j_init_tc(jax.random.key(0), D_IN, EF, D_OUT))
    params["b_enc"] = np.where(np.arange(H) < 8, -100.0, -0.05).astype(np.float32)  # 8 dead
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(T, D_IN)).astype(np.float32),
                rng.normal(size=(T, D_OUT)).astype(np.float32)) for _ in range(STEPS)]
    jtx = joptim.get_optimizer("constrained_adam", LR)
    jts = j_init_ts(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    jopts = dict(tile_t=32, tile_h=128, compute_dtype=jnp.float32, interpret=True)
    jstep = j_make(LAMBDA, jtx, N, EF, fused=fused, fused_opts=jopts if fused else None)
    ttx = toptim.get_optimizer("constrained_adam", LR)
    tts = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), ttx, H, seed=0)
    tstep = ttc.make_transcoder_train_step_from_acts(
        LAMBDA, ttx, N, EF, fused=fused, fused_opts={"compute_dtype": "float32"})
    resample_at = 2 * N + 1
    jl, tl = [], []
    for i, (x, y) in enumerate(batches, start=1):
        jts, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y))
        draws = _jax_step_draws(i) if i == resample_at else None
        tts, tm = tstep(tts, torch.from_numpy(x), torch.from_numpy(y), resample_draws=draws)
        jl.append(float(jm["sae_loss"]))
        tl.append(float(tm["sae_loss"]))
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc),
                                      err_msg=f"dead_acc at step {i}")
        np.testing.assert_allclose(float(tm["sparsity"]), float(jm["sparsity"]), rtol=1e-5)
        if i in (N, resample_at):
            assert float(tm["perc_dead"]) == 1.0
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    for k in params:
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=f"final {k}")
    assert float(tts.params["b_enc"][:8].min()) > -1.0  # the resample revived them


def test_multi_step_equals_single_steps():
    params = convert.sae_params_from_jax(jax.device_get(
        j_init_tc(jax.random.key(1), D_IN, EF, D_OUT)))
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(3, T, D_IN)).astype(np.float32))
    ys = torch.from_numpy(rng.normal(size=(3, T, D_OUT)).astype(np.float32))
    tx = toptim.get_optimizer("constrained_adam", LR)
    step = ttc.make_transcoder_train_step_from_acts(LAMBDA, tx, 100, EF, fused=True,
                                                    fused_opts={"compute_dtype": "float32"})
    ts_a = tsteps.init_sae_train_state(params, tx, H)
    ts_b = tsteps.init_sae_train_state(params, tx, H)
    ts_a, ms = ttc.make_transcoder_multi_step(step)(ts_a, xs, ys)
    losses = []
    for x, y in zip(xs, ys):
        ts_b, m = step(ts_b, x, y)
        losses.append(float(m["sae_loss"]))
    np.testing.assert_array_equal(ms["sae_loss"].numpy(), np.array(losses, np.float32))
    for k in params:
        np.testing.assert_array_equal(ts_a.params[k].numpy(), ts_b.params[k].numpy())
