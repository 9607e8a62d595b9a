"""A training trajectory through the port's make_sae_train_step_from_acts against
the JAX step on the same batches, crossing the measurement reset at step n and
the resample at step 2n+1 with some latents dead; the JAX resample draws are
injected into the port's step.

The fused case runs the JAX Pallas op in interpret mode with f32 compute
(tests/test_training_parity.py:103-105) against the port's plain fused op (the
CPU path of the CUDA kernels). Tolerances (tests/test_training_parity.py:114-119):
losses rtol 2e-4; final params rtol 2e-3, atol 2e-5 (Adam's first steps divide by
sqrt(nu) and amplify f32 rounding of tiny gradients); dead accumulators equal.

The gated, JumpReLU, Matryoshka, TopK and BatchTopK trajectories cross two
restarts of the rolling dead window (dead_neurons_steps = 2: steps 2 and 4),
stock and fused (the TopK family's fused step is its fast path; both run AuxK
with k_aux 32, weighted at steps 2 and 4, the mature halves of the windows),
with the same loss and dead-accumulator tolerances and params at rtol 2e-3,
atol 1e-5 (tests/test_fused_gated_sae.py:86-93). Matryoshka runs at 8x
expansion (512 latents) with prefixes 1/4, 1/2, 1, so that its boundaries (128,
256, 512) are multiples of the JAX kernel's 128-latent tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_sae, init_sae_mlp, kaiming_uniform
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu.train.steps import make_sae_train_step_from_acts as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.train import steps as tsteps

T, C, K, N, STEPS, LAMBDA, LR = 64, 64, 2, 3, 9, 0.5, 1e-3
H = C * K


def _setup():
    params = init_sae_mlp(jax.random.key(0), C, K)
    params = {**params, "b_enc": (params["b_enc"] - 0.05).at[:8].add(-100.0)}  # 8 dead
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(T, C)).astype(np.float32) for _ in range(STEPS)]
    return jax.device_get(params), batches


def _jax_resample_draws(step: int, seed: int = 0):
    """The draws the JAX step makes at 1-based ``step``: it splits its rng once
    per step and resample_dead_neurons splits the sub-key into (enc, dec)."""
    key = jax.random.key(seed)
    for _ in range(step):
        key, sub = jax.random.split(key)
    k_enc, k_dec = jax.random.split(sub)
    enc = np.array(kaiming_uniform(k_enc, (H, C), fan_in=C))
    dec = np.array(kaiming_uniform(k_dec, (C, H), fan_in=H))
    return torch.from_numpy(enc), torch.from_numpy(dec)


@pytest.mark.parametrize("fused", [True, False])
def test_trajectory_matches_jax_across_reset_and_resample(fused):
    params, batches = _setup()
    jtx = joptim.get_optimizer("constrained_adam", LR)
    jts = j_init(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    jopts = dict(tile_t=32, tile_h=128, compute_dtype=jnp.float32, interpret=True)
    jstep = j_make("sae_mlp", LAMBDA, jtx, N, K, fused=fused,
                   fused_opts=jopts if fused else None)

    ttx = toptim.get_optimizer("constrained_adam", LR)
    tts = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), ttx, H, seed=0)
    tstep = tsteps.make_sae_train_step_from_acts(
        "sae_mlp", LAMBDA, ttx, N, K, fused=fused, fused_opts={"compute_dtype": "float32"})

    resample_at = 2 * N + 1
    jl, tl = [], []
    for i, x in enumerate(batches, start=1):
        jts, jm = jstep(jts, jnp.asarray(x))
        draws = _jax_resample_draws(i) if i == resample_at else None
        tts, tm = tstep(tts, torch.from_numpy(x), resample_draws=draws)
        jl.append(float(jm["sae_loss"]))
        tl.append(float(tm["sae_loss"]))
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc),
                                      err_msg=f"dead_acc at step {i}")
        np.testing.assert_allclose(float(tm["perc_dead"]), float(jm["perc_dead"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["sparsity"]), float(jm["sparsity"]), rtol=1e-5)
        if i in (N, resample_at):  # reset / resample: the quirk reads the fresh all-True acc
            assert float(tm["perc_dead"]) == 1.0
    assert tts.step == int(jts.step) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    for k in params:
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=f"final {k}")
    # the resample revived the never-firing latents: their biases left -100
    assert float(tts.params["b_enc"][:8].min()) > -1.0


def test_multi_step_equals_single_steps():
    params, batches = _setup()
    tx = toptim.get_optimizer("constrained_adam", LR)
    step = tsteps.make_sae_train_step_from_acts("sae_mlp", LAMBDA, tx, 100, K, fused=True,
                                                fused_opts={"compute_dtype": "float32"})
    multi = tsteps.make_sae_train_multi_step(step)
    ts_a = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), tx, H)
    ts_b = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), tx, H)
    stack = torch.from_numpy(np.stack(batches[:4]))
    ts_a, ms = multi(ts_a, stack)
    losses = []
    for x in stack:
        ts_b, m = step(ts_b, x)
        losses.append(float(m["sae_loss"]))
    np.testing.assert_array_equal(ms["sae_loss"].numpy(), np.array(losses, np.float32))
    for k in params:
        np.testing.assert_array_equal(ts_a.params[k].numpy(), ts_b.params[k].numpy())
    assert ts_a.step == ts_b.step == 4


def test_unported_variant_raises():
    """An unknown name raises the JAX package's ValueError (the port's when
    the step is built, the JAX one's when it first runs); sae_conv reads maps
    and has no cached-token step."""
    tx = toptim.get_optimizer("adam", LR)
    with pytest.raises(ValueError, match="Unknown SAE model name no_such_sae"):
        tsteps.make_sae_train_step_from_acts("no_such_sae", LAMBDA, tx, 10, K)
    params, batches = _setup()
    jtx = joptim.get_optimizer("adam", LR)
    jstep = j_make("no_such_sae", LAMBDA, jtx, 10, K)
    with pytest.raises(ValueError, match="Unknown SAE model name no_such_sae"):
        jstep(j_init(jax.tree.map(jnp.asarray, params), jtx, H), jnp.asarray(batches[0]))
    with pytest.raises(ValueError, match="sae_conv reads feature maps"):
        tsteps.make_sae_train_step_from_acts("sae_conv", LAMBDA, tx, 10, K)


@pytest.mark.parametrize("opt_name", ["constrained_adam", "adam"])
def test_state_converted_mid_run_continues_like_jax(opt_name):
    """convert.train_state_from_jax carries params, Adam moments and count,
    the step counter and the dead accumulator: after 4 JAX steps both packages
    continue through the reset at step 2n = 6 to the same state."""
    params, batches = _setup()
    jtx = joptim.get_optimizer(opt_name, LR)
    jts = j_init(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    jstep = j_make("sae_mlp", LAMBDA, jtx, 2 * N, K)
    for x in batches[:4]:
        jts, _ = jstep(jts, jnp.asarray(x))
    tts = convert.train_state_from_jax(jax.device_get(jts))
    assert tts.step == 4 and tts.opt_state["count"] == 4
    np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
    tstep = tsteps.make_sae_train_step_from_acts("sae_mlp", LAMBDA, toptim.get_optimizer(
        opt_name, LR), 2 * N, K)
    for x in batches[4:7]:
        jts, jm = jstep(jts, jnp.asarray(x))
        tts, tm = tstep(tts, torch.from_numpy(x))
        np.testing.assert_allclose(float(tm["sae_loss"]), float(jm["sae_loss"]), rtol=2e-4)
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
    for k in params:
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# gated_sae, jumprelu_sae and matryoshka_sae: the rolling dead window
# ---------------------------------------------------------------------------

EPS = 0.5  # JumpReLU STE bandwidth: the window catches pre-activations of these inputs
WINDOW = 2  # dead_neurons_steps: the accumulator restarts after steps 2 and 4
EXPANSION = {"matryoshka_sae": 8}  # the others: K
PREFIXES = (0.25, 0.5, 1.0)
TOPK, AUX_K = 16, 32  # the TopK family's k and AuxK's k_aux


def _variant_setup(name):
    """JAX-initialized params with 8 latents that never fire, and 5 batches."""
    rng = np.random.default_rng(7)
    k = EXPANSION.get(name, K)
    h = C * k
    p = jax.device_get(init_sae(name, jax.random.key(0), C, k))
    if name in ("matryoshka_sae", "topk_sae", "batch_topk_sae"):
        p["b_enc"] = np.where(np.arange(h) < 8, -100.0, 0.0) + rng.normal(0.0, 0.05, h)
    elif name == "gated_sae":
        p["b_gate"] = (rng.normal(0.0, 0.05, h) - np.where(np.arange(h) < 8, 100.0, 0.0))
        p["b_mag"] = rng.normal(0.0, 0.05, h)
        p["r_mag"] = rng.normal(0.0, 0.1, h)
    else:
        p["b_enc"] = np.where(np.arange(h) < 8, -100.0, 0.0) + rng.normal(0.0, 0.05, h)
        p["log_threshold"] = np.log(rng.uniform(0.2, 0.6, h))
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    batches = [rng.normal(size=(T, C)).astype(np.float32) for _ in range(5)]
    return p, batches


def _jax_step(name, tx, fused, window=WINDOW):
    jopts = dict(tile_t=32, tile_h=128, compute_dtype=jnp.float32, interpret=True)
    if name == "jumprelu_sae":
        jopts["bandwidth"] = EPS
    return j_make(name, LAMBDA, tx, window, EXPANSION.get(name, K), fused=fused,
                  fused_opts=jopts if fused else None, jumprelu_bandwidth=EPS,
                  matryoshka_prefixes=PREFIXES, topk=TOPK, aux_k=AUX_K)


def _torch_step(name, tx, fused, window=WINDOW):
    opts = {"compute_dtype": "float32"}
    if name == "jumprelu_sae":
        opts["bandwidth"] = EPS
    return tsteps.make_sae_train_step_from_acts(
        name, LAMBDA, tx, window, EXPANSION.get(name, K), fused=fused, fused_opts=opts,
        jumprelu_bandwidth=EPS, matryoshka_prefixes=PREFIXES, topk=TOPK, aux_k=AUX_K)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["gated_sae", "jumprelu_sae", "matryoshka_sae", "topk_sae",
                                  "batch_topk_sae"])
def test_rolling_dead_window_trajectory_matches_jax(name, fused):
    params, batches = _variant_setup(name)
    h = C * EXPANSION.get(name, K)
    jtx = joptim.get_optimizer("constrained_adam", LR)
    jts = j_init(jax.tree.map(jnp.asarray, params), jtx, h, seed=0)
    jstep = _jax_step(name, jtx, fused)
    ttx = toptim.get_optimizer("constrained_adam", LR)
    tts = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), ttx, h, seed=0)
    tstep = _torch_step(name, ttx, fused)

    jl, tl = [], []
    for i, x in enumerate(batches, start=1):
        jts, jm = jstep(jts, jnp.asarray(x))
        tts, tm = tstep(tts, torch.from_numpy(x))
        jl.append(float(jm["sae_loss"]))
        tl.append(float(tm["sae_loss"]))
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc),
                                      err_msg=f"dead_acc at step {i}")
        np.testing.assert_allclose(float(tm["perc_dead"]), float(jm["perc_dead"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["sparsity"]), float(jm["sparsity"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["sae_l1_loss"]), float(jm["sae_l1_loss"]),
                                   rtol=2e-4)
        if i % WINDOW == 0:  # the restart: perc_dead reads the fresh all-True acc
            assert float(tm["perc_dead"]) == 1.0
        else:  # between restarts only the never-firing latents stay dead
            assert 8 / h <= float(tm["perc_dead"]) < 0.5
        if "sae_aux_loss" in jm:  # AuxK: reported every step, weighted when mature
            np.testing.assert_allclose(float(tm["sae_aux_loss"]), float(jm["sae_aux_loss"]),
                                       rtol=2e-4)
            assert float(tm["sae_aux_loss"]) > 0
    assert tts.step == int(jts.step) == len(batches)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    for k in params:
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=1e-5, err_msg=f"final {k}")
    if name == "jumprelu_sae":  # the STE moved the thresholds
        assert bool((tts.params["log_threshold"] != torch.from_numpy(
            params["log_threshold"])).any())
    if name == "batch_topk_sae":  # the EMA, not the optimizer, moved the threshold
        assert float(tts.params["threshold"]) > 0


@pytest.mark.parametrize("name", ["gated_sae", "jumprelu_sae"])
def test_variant_state_converted_mid_run_continues_like_jax(name):
    """convert.train_state_from_jax carries the variant's own params (W_gate,
    b_gate, b_mag, r_mag; log_threshold) with their Adam moments: after 3 JAX
    steps both packages continue through the window restart at step 4 alike."""
    params, batches = _variant_setup(name)
    jtx = joptim.get_optimizer("constrained_adam", LR)
    jts = j_init(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    jstep = _jax_step(name, jtx, fused=False)
    for x in batches[:3]:
        jts, _ = jstep(jts, jnp.asarray(x))
    host = jax.device_get(jts)
    tts = convert.train_state_from_jax(host)
    assert tts.step == 3 and tts.opt_state["count"] == 3
    assert set(tts.params) == set(params) == set(tts.opt_state["mu"]) == set(tts.opt_state["nu"])
    for k in params:
        np.testing.assert_array_equal(tts.params[k].numpy(), np.asarray(host.params[k]))
        np.testing.assert_array_equal(tts.opt_state["mu"][k].numpy(),
                                      np.asarray(host.opt_state.mu[k]))
        np.testing.assert_array_equal(tts.opt_state["nu"][k].numpy(),
                                      np.asarray(host.opt_state.nu[k]))
    tstep = _torch_step(name, toptim.get_optimizer("constrained_adam", LR), fused=False)
    for i, x in enumerate(batches[3:], start=4):
        jts, jm = jstep(jts, jnp.asarray(x))
        tts, tm = tstep(tts, torch.from_numpy(x))
        np.testing.assert_allclose(float(tm["sae_loss"]), float(jm["sae_loss"]), rtol=2e-4)
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
        assert (float(tm["perc_dead"]) == 1.0) == (i == 4)
    for k in params:
        np.testing.assert_allclose(tts.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,prefixes,t,h,ok", [
    ("matryoshka_sae", (0.0625, 0.25, 1.0), 32768, 16384, True),  # 1024/4096/16384
    ("matryoshka_sae", (0.25, 0.5, 1.0), 128, 512, True),  # 128/256/512
    ("matryoshka_sae", (0.0625, 0.25, 1.0), 128, 512, False),  # 32: inside a 64-latent tile
    ("sae_mlp", (0.0625, 0.25, 1.0), 128, 512, True),  # the prefixes are Matryoshka's only
])
def test_fused_op_can_fuse_reads_the_prefix_boundaries(name, prefixes, t, h, ok):
    """fused_op binds matryoshka_sae's prefix fractions into its can_fuse, which
    the Pipeline asks before it trains on the card."""
    can_fuse, _ = tsteps.fused_op(name, prefixes)
    assert can_fuse(t, h, 256) is ok


@pytest.mark.parametrize("fused", [True, False])
def test_dequant_steps_match_jax_on_an_int8_stack(fused):
    """make_dequant_step_fn and make_sae_train_multi_step_quant on one int8 stack
    and its per-channel scale (data/activation_cache.quantize_int8) against the
    JAX wrappers: the f32 dequantization q·scale is exact on both sides, so the
    tolerances are the trajectory's (losses rtol 2e-4; params rtol 2e-3, atol
    2e-5); the port's two wrappers agree with each other bitwise."""
    from sparse_vision_tpu.data.activation_cache import quantize_int8
    from sparse_vision_tpu.train.steps import make_sae_train_multi_step_quant as j_multi_q

    params, batches = _setup()
    q, scale = quantize_int8(np.concatenate(batches[:4]) * 3.0)
    q = q.reshape(4, T, C)
    jtx = joptim.get_optimizer("constrained_adam", LR)
    jts = j_init(jax.tree.map(jnp.asarray, params), jtx, H, seed=0)
    jopts = dict(tile_t=32, tile_h=128, compute_dtype=jnp.float32, interpret=True)
    jstep = j_make("sae_mlp", LAMBDA, jtx, 100, K, fused=fused,
                   fused_opts=jopts if fused else None)
    jts, jms = j_multi_q(jstep)(jts, jnp.asarray(q), jnp.asarray(scale))

    ttx = toptim.get_optimizer("constrained_adam", LR)
    tstep = tsteps.make_sae_train_step_from_acts(
        "sae_mlp", LAMBDA, ttx, 100, K, fused=fused, fused_opts={"compute_dtype": "float32"})
    tq, tscale = torch.from_numpy(q), torch.from_numpy(scale)
    ts_a = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), ttx, H)
    ts_a, ms = tsteps.make_sae_train_multi_step_quant(tstep)(ts_a, tq, tscale)
    ts_b = tsteps.init_sae_train_state(convert.sae_params_from_jax(params), ttx, H)
    step_q = tsteps.make_dequant_step_fn(tstep)
    for x in tq:
        ts_b, _ = step_q(ts_b, x, tscale)
    np.testing.assert_allclose(ms["sae_loss"].numpy(), np.asarray(jms["sae_loss"]), rtol=2e-4)
    for k in params:
        np.testing.assert_allclose(ts_a.params[k].numpy(), np.asarray(jts.params[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=k)
        np.testing.assert_array_equal(ts_a.params[k].numpy(), ts_b.params[k].numpy())
    assert ts_a.step == ts_b.step == int(jts.step) == 4
