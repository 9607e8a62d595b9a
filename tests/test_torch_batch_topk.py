"""The port's BatchTopK SAE (sparse_vision_tpu_torch/models/sae.py: the batch-level
selection, the threshold EMA and its calibration, AuxK; ops/fast_batch_topk.py:
kth_largest and the index-selecting fast path; the Pipeline's calibration after the
last cached epoch) against the JAX package's on the same numpy inputs and
JAX-initialized weights (convert.py), mirroring tests/test_batch_topk.py without
its sharded, vmap and e2e-finetune cases.

kth_largest is held to JAX's result bit for bit (ties and ±0 included).
Tolerances (f32, sums in another order): values rtol 1e-5 / atol 1e-6, the
threshold observation rtol 1e-6, gradients rtol 1e-5 / atol 1e-7; train
trajectories: losses and the threshold rtol 2e-4, params rtol 2e-3 / atol 2e-5
(tests/test_training_parity.py:114-119), the dead accumulators equal. The two
Pipelines (32 px GoogLeNet, 8 steps of 128 tokens; JAX's stock step on the CPU,
the port's fast path) are held as tests/test_torch_pipeline.py holds its runs:
losses and eval means rtol 1e-4, loss_diff and kld atol 1e-5, counting metrics
exactly; the calibrated thresholds rtol 1e-4. The JAX Pipeline is set up
through test_torch_pipeline.quick_jax_pipeline.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models import sae as jsae
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.fast_batch_topk import fast_batch_topk_sae_loss_terms as j_fast
from sparse_vision_tpu.ops.fast_batch_topk import kth_largest as j_kth
from sparse_vision_tpu.train import pipeline as j_pipeline
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu.train.steps import make_sae_train_step_from_acts as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import sae as tsae
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.ops.fast_batch_topk import fast_batch_topk_sae_loss_terms as t_fast
from sparse_vision_tpu_torch.ops.fast_batch_topk import kth_largest as t_kth
from sparse_vision_tpu_torch.ops.fast_batch_topk import ordered_keys
from sparse_vision_tpu_torch.train import steps as tsteps
from test_torch_pipeline import _datasets, quick_jax_pipeline

D, EXP, K = 16, 4, 5
TERMS = ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's work here is small: one intra-op thread is as fast alone, and
    much faster when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, rtol=1e-5, atol=1e-6, msg=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


def _params(seed, d=D, exp=EXP):
    p = jax.device_get(jsae.init_sae("batch_topk_sae", jax.random.key(seed), d, exp))
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in p.items()}
    p["b_enc"] = rng.normal(0.0, 0.1, p["b_enc"].shape).astype(np.float32)
    p["b_dec"] = rng.normal(0.0, 0.1, p["b_dec"].shape).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_batch_topk_matches_jax_and_numpy_golden():
    p, x = _params(0), _x(0, (32, D))
    enc, dec, pre, mp = tsae.batch_topk_sae_apply(convert.sae_params_from_jax(p),
                                                  torch.from_numpy(x), K)
    jenc, jdec, jpre, jmp = jsae.batch_topk_sae_apply(_j(p), jnp.asarray(x), K)
    gpre = (x - p["b_dec"]) @ p["W_enc"] + p["b_enc"]
    flat = gpre.reshape(-1)
    idx = np.argsort(flat)[::-1][:32 * K]
    genc = np.zeros_like(flat)
    genc[idx] = np.maximum(flat[idx], 0.0)
    genc = genc.reshape(gpre.shape)
    for got, want, golden, name in ((pre, jpre, gpre, "pre"), (enc, jenc, genc, "enc"),
                                    (dec, jdec, genc @ p["W_dec"] + p["b_dec"], "dec")):
        close(got, want, msg=name)
        close(got, golden, msg=name)
    close(mp, jmp, rtol=1e-6)
    close(mp, genc[genc > 0].min(), rtol=1e-6)


def test_batch_topk_budget_is_batch_level():
    p, x = _params(1), _x(1, (16, D))
    x[:8] *= 5.0  # half the tokens carry much more energy
    enc, _, _, _ = tsae.batch_topk_sae_apply(convert.sae_params_from_jax(p), torch.from_numpy(x), K)
    l0 = (enc != 0).sum(1).numpy()
    assert l0.sum() <= 16 * K and l0.max() > K and l0.min() < K, l0


def test_batch_topk_gradients_flow_only_through_selected_and_never_to_the_threshold():
    p, x = _params(3), _x(3, (8, D))
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(p).items()}
    enc, dec, _, _ = tsae.batch_topk_sae_apply(tp, torch.from_numpy(x), K)
    g = torch.autograd.grad(torch.square(dec - torch.from_numpy(x)).mean(), list(tp.values()),
                            allow_unused=True)
    g = dict(zip(tp, g))
    jg = jax.grad(lambda q: jnp.mean(jnp.square(
        jsae.batch_topk_sae_apply(q, jnp.asarray(x), K)[1] - jnp.asarray(x))))(_j(p))
    assert g["threshold"] is None and float(jg["threshold"]) == 0.0
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        close(g[k], jg[k], atol=1e-7, msg=k)
    selected = (enc > 0).any(0).numpy()
    assert (g["b_enc"].numpy()[~selected] == 0).all()
    assert np.abs(g["b_enc"].numpy()[selected]).max() > 0


def test_threshold_ema_seeds_then_averages_as_in_jax():
    steps = [(0.0, 0.5, 0.99), (0.5, 1.5, 0.9), (0.6, 0.0, 0.99), (0.25, 0.75, 0.99)]
    for thr, obs, ema in steps:
        got = tsae.batch_topk_threshold_update(torch.tensor(thr), torch.tensor(obs), ema=ema)
        want = jsae.batch_topk_threshold_update(jnp.float32(thr), jnp.float32(obs), ema=ema)
        assert got.dtype == torch.float32
        close(got, want, rtol=1e-7, atol=0)
    assert float(tsae.batch_topk_threshold_update(torch.tensor(0.0), torch.tensor(0.5))) == 0.5
    kept = tsae.batch_topk_threshold_update(torch.tensor(0.6), torch.tensor(0.0))
    assert torch.equal(kept, torch.tensor(0.6))  # no positive observation


def test_train_step_estimates_threshold_and_eval_uses_it():
    """The first step seeds the threshold with that batch's minimum positive
    selected value, later ones average in (as JAX's step); inference gates
    every surviving activation strictly above it, and sae_encode (the circuit
    tier's entry) is the same deployment form, in both packages."""
    p = _params(0)
    ttx = toptim.get_optimizer("constrained_adam", 1e-3)
    ts = tsteps.init_sae_train_state(convert.sae_params_from_jax(p), ttx, D * EXP)
    step = tsteps.make_sae_train_step_from_acts("batch_topk_sae", 0.0, ttx, 10_000, EXP, topk=K)
    jtx = joptim.get_optimizer("constrained_adam", 1e-3)
    jts = j_init(_j(p), jtx, D * EXP)
    jstep = j_make("batch_topk_sae", 0.0, jtx, 10_000, EXP, topk=K)
    x0 = _x(0, (32, D))
    _, _, _, mp0 = tsae.batch_topk_sae_apply(ts.params, torch.from_numpy(x0), K)
    for s in range(4):
        x = x0 if s == 0 else _x(s, (32, D))
        ts, m = step(ts, torch.from_numpy(x))
        jts, jm = jstep(jts, jnp.asarray(x))
        if s == 0:
            assert float(ts.params["threshold"]) == float(mp0)
        close(ts.params["threshold"], jts.params["threshold"], rtol=2e-4, msg=f"step {s}")
    thr = float(ts.params["threshold"])
    assert thr > 0
    out = tsae.sae_inference_and_loss("batch_topk_sae", ts.params, torch.from_numpy(x0), 0.0,
                                      topk=K, training=False)
    enc = out["encoded"].numpy()
    assert (enc[enc > 0] > thr).all() and "batch_topk_min_pos" not in out
    np.testing.assert_array_equal(enc, tsae.sae_encode("batch_topk_sae", ts.params,
                                                       torch.from_numpy(x0)).numpy())
    jenc = jsae.sae_encode("batch_topk_sae", jts.params, jnp.asarray(x0))
    np.testing.assert_array_equal(enc != 0, np.asarray(jenc) != 0)
    close(enc, jenc, rtol=2e-3, atol=2e-5)


def _kth_inputs(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        return rng.normal(size=4096).astype(np.float32)
    if kind == "tied":
        return np.concatenate([rng.normal(size=500), -rng.exponential(size=300),
                               np.repeat(rng.normal(size=10), 5), [0.0, -0.0, 1e-38, -1e-38],
                               [np.inf, -np.inf]]).astype(np.float32)
    # ±0 and the subnormals around them: -0.0 sorts just below +0.0 in JAX's order
    return np.array([0.0, -0.0, -0.0, 0.0, 1e-45, -1e-45, -1.0, 1.0, 0.0], np.float32)


@pytest.mark.parametrize("kind", ["random", "tied", "signed_zeros"])
def test_kth_largest_returns_jax_bits(kind):
    """The exact cutoff, bit for bit JAX's radix bisection, for every n on the small
    inputs and a spread of n on the large one; the ordered keys sort as the
    floats do (with -0.0 < +0.0)."""
    x = _kth_inputs(kind)
    ns = range(1, len(x) + 1) if len(x) < 64 else (1, 2, 7, 100, 854, len(x) - 1, len(x))
    for n in ns:
        got = t_kth(torch.from_numpy(x), n)
        want = np.asarray(j_kth(jnp.asarray(x), n))
        assert got.shape == () and got.dtype == torch.float32
        assert got.numpy().view(np.int32) == want.view(np.int32), (n, float(got), float(want))
        assert float(got) == np.sort(x)[::-1][n - 1]
    keys = ordered_keys(torch.from_numpy(x)).numpy()
    order = np.lexsort((np.signbit(x) == 0, x))  # by value, -0.0 before +0.0
    assert (np.diff(keys[order]) >= 0).all()


def test_fast_batch_topk_matches_jax_fast_and_stock_terms_and_grads():
    d, exp, k, t = 32, 8, 8, 96
    p, tok = _params(7, d, exp), _x(7, (t, d))
    tp = {k_: v.requires_grad_(True) for k_, v in convert.sae_params_from_jax(p).items()}
    fast = t_fast(tp, torch.from_numpy(tok), 0.0, exp, k)
    jfast = j_fast(_j(p), jnp.asarray(tok), 0.0, exp, k)
    jstock = jsae.sae_inference_and_loss("batch_topk_sae", _j(p), jnp.asarray(tok), 0.0, topk=k)
    for key in (*TERMS, "batch_topk_min_pos"):
        close(fast[key], jfast[key], msg=key)
        close(fast[key], jstock[key], msg=key)
    for key in ("encoded", "encoded_pre", "decoded", "activity_freq", "sparsity"):
        close(fast[key], jfast[key], msg=key)
    np.testing.assert_array_equal(fast["encoded"].detach().numpy() != 0,
                                  np.asarray(jstock["encoded"]) != 0)
    np.testing.assert_array_equal(fast["dead"].numpy(), np.asarray(jfast["dead"]))
    g = torch.autograd.grad(fast["loss"], list(tp.values()), allow_unused=True)
    g = dict(zip(tp, g))
    jg = jax.grad(lambda q: j_fast(q, jnp.asarray(tok), 0.0, exp, k)["loss"])(_j(p))
    jgs = jax.grad(lambda q: jsae.sae_inference_and_loss(
        "batch_topk_sae", q, jnp.asarray(tok), 0.0, topk=k)["loss"])(_j(p))
    for key in ("W_enc", "b_enc", "W_dec", "b_dec"):
        close(g[key], jg[key], atol=1e-7, msg=key)
        close(g[key], jgs[key], atol=1e-7, msg=key)


def test_fast_batch_topk_keeps_exactly_the_budget_under_ties():
    """Every pre-activation tied (W_enc 0, b_enc 1): the index selection keeps
    exactly T·k entries, as the stock path does (JAX's cutoff mask would keep
    all of them), and its statistics count those entries."""
    d, exp, k, t = 8, 4, 3, 10
    p = {key: torch.from_numpy(v) for key, v in _params(3, d, exp).items()}
    p["W_enc"] = torch.zeros_like(p["W_enc"])
    p["b_enc"] = torch.ones_like(p["b_enc"])
    x = torch.from_numpy(_x(3, (t, d)))
    fast = t_fast(p, x, 0.0, exp, k)
    stock = tsae.sae_inference_and_loss("batch_topk_sae", p, x, 0.0, topk=k)
    assert int((fast["encoded"] != 0).sum()) == int((stock["encoded"] != 0).sum()) == t * k
    assert int(fast["activity_freq"].sum() * t) == t * k
    assert float(fast["sparsity"]) == pytest.approx(k / d)  # latents a token over d
    assert float(fast["batch_topk_min_pos"]) == 1.0
    assert float(fast["l1_loss"]) == pytest.approx(t * k / (t * d * exp))


def test_topk_aux_loss_semantics_match_jax():
    """0 when nothing is dead; otherwise JAX's value, and gradients only on the
    dead latents' encoder columns and decoder rows (Gao et al. 2024 §A.2)."""
    p, x = _params(0), _x(1, (32, D))
    residual = x - _x(2, (32, D)) * 0.5
    h = D * EXP
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(p).items()}
    none = tsae.topk_aux_loss(tp, torch.from_numpy(x), torch.from_numpy(residual),
                              torch.zeros(h, dtype=torch.bool), 4)
    assert float(none.detach()) == 0.0
    dead = np.zeros(h, bool)
    dead[:8] = True
    loss = tsae.topk_aux_loss(tp, torch.from_numpy(x), torch.from_numpy(residual),
                              torch.from_numpy(dead), 4)
    jloss, jg = jax.value_and_grad(lambda q: jsae.topk_aux_loss(
        q, jnp.asarray(x), jnp.asarray(residual), jnp.asarray(dead), 4))(_j(p))
    close(loss, jloss)
    g = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()), allow_unused=True)))
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        close(g[k], jg[k], atol=1e-7, msg=k)
    assert float(loss.detach()) > 0
    dwe, dwd = g["W_enc"].numpy(), g["W_dec"].numpy()
    assert np.any(dwe[:, :8] != 0) and np.any(dwd[:8] != 0)
    assert (dwe[:, 8:] == 0).all() and (dwd[8:] == 0).all()
    # maps flatten to tokens as in the main loss
    maps = tsae.topk_aux_loss(tp, torch.from_numpy(x).reshape(2, 4, 4, D),
                              torch.from_numpy(residual).reshape(2, 4, 4, D),
                              torch.from_numpy(dead), 4)
    close(maps, loss.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_batch_topk_steps_with_auxk_match_jax_across_a_window_restart(fused):
    """Six steps of make_sae_train_step_from_acts with AuxK (k_aux 16, α 1/32)
    over a 4-step rolling dead window against JAX's step: the aux term is
    reported every step and weighted only at steps 3-4 of each window (its
    mature half), the threshold follows the EMA, the dead accumulator restarts
    at step 4; and the aux-on trajectory leaves the aux-off one."""
    d, exp, k = 16, 8, 2
    p = _params(3, d, exp)
    p["b_enc"][: d * exp // 4] -= 100.0  # a quarter of the latents never fire
    batches = [_x(100 + i, (64, d)) for i in range(6)]

    def port(aux_k):
        tx = toptim.get_optimizer("constrained_adam", 2e-3)
        ts = tsteps.init_sae_train_state(convert.sae_params_from_jax(p), tx, d * exp)
        step = tsteps.make_sae_train_step_from_acts("batch_topk_sae", 0.0, tx, 4, exp,
                                                    fused=fused, topk=k, aux_k=aux_k,
                                                    aux_alpha=1 / 32)
        ms = []
        for x in batches:
            ts, m = step(ts, torch.from_numpy(x))
            ms.append(m)
        return ts, ms

    jtx = joptim.get_optimizer("constrained_adam", 2e-3)
    jts = j_init(_j(p), jtx, d * exp)
    jstep = j_make("batch_topk_sae", 0.0, jtx, 4, exp, fused=fused, topk=k, aux_k=16,
                   aux_alpha=1 / 32)
    tts, tms = port(16)
    for i, (x, tm) in enumerate(zip(batches, tms), start=1):
        jts, jm = jstep(jts, jnp.asarray(x))
        assert set(tm) == set(jm)
        for key in jm:
            close(tm[key], jm[key], rtol=2e-4, msg=f"step {i} {key}")
        assert float(tm["sae_aux_loss"]) > 0
        assert (float(tm["perc_dead"]) == 1.0) == (i == 4)
    np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
    for key in p:
        close(tts.params[key], jts.params[key], rtol=2e-3, atol=2e-5, msg=key)
    off, off_ms = port(0)
    assert "sae_aux_loss" not in off_ms[0]
    # steps 1-2 are immature: the same update with and without AuxK
    assert off_ms[1]["sae_loss"] == tms[1]["sae_loss"]
    assert not torch.allclose(off.params["W_dec"], tts.params["W_dec"])


def test_batch_topk_threshold_calibration_matches_jax():
    p, tok = _params(3), _x(4, (128, D))
    thr = tsae.calibrate_batch_topk_threshold(convert.sae_params_from_jax(p),
                                              torch.from_numpy(tok), 3)
    jthr = jsae.calibrate_batch_topk_threshold(_j(p), jnp.asarray(tok), 3)
    close(thr, jthr, rtol=1e-6, atol=0)
    pre = (tok - p["b_dec"]) @ p["W_enc"] + p["b_enc"]
    relu = np.maximum(pre, 0.0)
    assert (relu * (relu > float(thr)) > 0).sum(-1).mean() <= 3 + 0.5 and float(thr) >= 0


CFG = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
           sae_model_name="batch_topk_sae", sae_expansion_factor=2, sae_lambda_sparse=0.0,
           sae_topk=4, sae_aux_k=16, sae_optimizer_name="constrained_adam",
           sae_learning_rate=1e-3, sae_batch_size=16, use_activation_cache=True,
           cache_tokens_per_step=128, cache_dtype="float32", compute_dtype="float32",
           sae_epochs=1, dead_neurons_steps=4, seed=3)


def test_both_pipelines_calibrate_the_cached_runs_threshold(tmp_path):
    """A cached batch_topk run of both Pipelines (AuxK on, a 4-step dead
    window): the losses and eval means agree; each run ends with the threshold
    calibrated at its final parameters on the JAX package's block (re-derived
    here from the port's cache), not its EMA; the epoch-1 checkpoint and the
    export carry it."""
    from sparse_vision_tpu.config import RunConfig as JConfig
    from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
    from sparse_vision_tpu_torch.config import RunConfig as TConfig
    from sparse_vision_tpu_torch.data.activation_cache import ActivationCache
    from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
    from sparse_vision_tpu_torch.train import checkpoint as tckpt
    from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

    with quick_jax_pipeline():
        jpipe = j_pipeline.Pipeline(JConfig(**CFG, directory_path=str(tmp_path / "jax")),
                                    datasets=_datasets(j_synth))
    tpipe = TPipeline(TConfig(**CFG, directory_path=str(tmp_path / "torch")), device="cpu",
                      datasets=_datasets(t_synth),
                      backbone=convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                                         jax.device_get(jpipe.net_state)),
                      sae_params=convert.sae_params_from_jax(jax.device_get(jpipe.ts.params)))
    jpipe.CACHE_SCAN_K = tpipe.CACHE_SCAN_K = 2
    emas, recalibrate = [], tpipe._recalibrate_batch_topk

    def record_ema(cache, tps):
        emas.append(float(tpipe.ts.params["threshold"]))
        recalibrate(cache, tps)

    tpipe._recalibrate_batch_topk = record_ema
    with quick_jax_pipeline():
        jmeans = jpipe.train_sae()
    tmeans = tpipe.train_sae()
    steps = dict(tpipe.train_log)
    assert sorted(steps) == list(range(1, 9))
    thr = float(tpipe.ts.params["threshold"])
    close(thr, jpipe.ts.params["threshold"], rtol=1e-4, atol=0)
    for k, jv in jmeans.items():
        if k in ("perc_same", "perc_dead_units", "accuracy"):
            assert tmeans[k] == pytest.approx(jv, abs=1e-6), k
        elif k in ("loss_diff", "kld"):
            np.testing.assert_allclose(tmeans[k], jv, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(tmeans[k], jv, rtol=1e-4, atol=1e-7, err_msg=k)
    cfg = tpipe.cfg
    cache = ActivationCache(tpipe._cache_dir(cfg.sae_layer))
    tok = next(iter(cache.batches(128, shuffle=True, seed=cfg.seed + 7919, prefetch=False)))
    expect = tsae.calibrate_batch_topk_threshold(tpipe.ts.params, tok.float(), cfg.sae_topk)
    assert thr == float(expect) > 0
    assert len(emas) == 1 and emas[0] > 0 and emas[0] != thr  # the EMA it replaced
    tree = tckpt.load_checkpoint(tpipe._sae_ckpt_dir(), 1, like=tpipe._ckpt_tree())
    assert float(tree["params"]["threshold"]) == thr
    npz = [f for f in os.listdir(tpipe.paths["sae_weights"]) if f.endswith(".npz")]
    with np.load(os.path.join(tpipe.paths["sae_weights"], npz[0])) as z:
        assert float(z["threshold"]) == thr
    # a standalone eval of the checkpoint runs at the calibrated threshold
    again = TPipeline(dataclasses.replace(cfg, training=False, sae_checkpoint_epoch=1),
                      device="cpu", datasets=_datasets(t_synth), backbone=(
                          tpipe.frozen_params, tpipe.net_state))
    assert float(again.ts.params["threshold"]) == thr
    np.testing.assert_allclose(again.run()["sae_rec_loss"], tmeans["sae_rec_loss"], rtol=1e-6)
