"""The vmapped hyperparameter sweep (sparse_vision_tpu_torch/train/sweep_vmap.py
and the fused ops' sweep Functions) against the JAX package's
train/sweep_vmap.py, on the CPU, where the fused sweep ops run the plain
versions of their CUDA kernels (the card holds the kernels to these).

- (a) Each sweep op (ReLU, gated, JumpReLU, Matryoshka) against the JAX fused
  op under jax.vmap in interpret mode (pallas_call's batching rule), f32, at
  tests/test_sweep_vmap.py:195's shapes (C 128, H 512, tile_t 32, tile_h 128):
  per-combo loss terms, dead masks and sparsity, and every gradient, at 1e-5
  relative (of each gradient's largest entry).
- (b) make_sae_sweep_step against JAX's, stock and fused, for sae_mlp across a
  measurement reset and a resample (dead_neurons_steps 2: the resample at step
  5, JAX's per-combo draws injected) and the variants of
  tests/test_sweep_vmap.py:90 across two restarts of their rolling window;
  losses rtol 2e-4, params rtol 2e-3 / atol 2e-5 (tests/test_torch_steps.py's
  bounds: Adam amplifies f32 rounding of tiny gradients), dead accumulators
  equal. topk_sae's fused sweep runs the stock TopK math under vmap (the
  module's docstring), JAX's its fast path.
- (c) The port's sweep step against N runs of its own single-device step: the
  fused plain sweep bitwise (the same plain versions on each combo's slices,
  the same order of operations), the stock vmap within 1e-6 relative (batched
  products sum in another order), the TopK sweep's stock math against the
  single step's fast path within 1e-4 relative, 1e-6 absolute.
- (d) The transcoder and crosscoder sweep steps against JAX's across a
  resample, JAX's draws injected.
- (e) The cached trainers end to end against JAX's on custom_mlp_9 with
  synthetic data (both packages on the same data, backbone and initial
  dictionaries: the port's Pipelines get JAX's initial weights through a
  monkeypatched init): final eval means, the epoch checkpoints, the results
  CSV rows, the crosscoder's decoder-norm CSV; and a resumed sweep equal to a
  straight one.
- (f) group_sweepable and _validate_overrides on JAX's cases.
- (g) The CLI's --parameters / --line / --vmap_sweep on JSONL and legacy files.
The legacy lines and Sweep (h) are tests/test_torch_config_legacy.py's.
"""

import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu import config as jconfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.models import backbone as j_backbone
from sparse_vision_tpu.models.crosscoder import init_crosscoder as j_init_crosscoder
from sparse_vision_tpu.models.sae import init_sae as j_init_sae
from sparse_vision_tpu.models.sae import init_transcoder as j_init_transcoder
from sparse_vision_tpu.models.sae import kaiming_uniform
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.train import steps as jsteps
from sparse_vision_tpu.train import sweep_vmap as jsweep
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import cli as tcli
from sparse_vision_tpu_torch import config as tconfig
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.ops import (
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
)
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.train import checkpoint as tckpt
from sparse_vision_tpu_torch.train import pipeline as tpipeline
from sparse_vision_tpu_torch.train import steps as tsteps
from sparse_vision_tpu_torch.train import sweep_vmap as tsweep
from test_torch_pipeline import quick_jax_pipeline


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (a), and the fused steps of (b) and (c): the JAX sweep test's fused shapes
FC, FEF, FT = 128, 4, 64
J_FUSED = {"interpret": True, "compute_dtype": jnp.float32, "tile_t": 32, "tile_h": 128}
T_FUSED = {"compute_dtype": "float32"}
# the stock steps' shapes (tests/test_sweep_vmap.py:33)
SD, SEF, ST = 16, 4, 32
LAMBDAS, LRS, SEEDS = (0.05, 0.2, 0.5), (1e-3, 2e-3, 1e-3), (1, 2, 3)
# sae_model_name -> (the variant's step keywords, its fused sweep op)
VARIANT_KW = {
    "sae_mlp": {},
    "gated_sae": {},
    "jumprelu_sae": {"jumprelu_bandwidth": 0.5},
    "matryoshka_sae": {"matryoshka_prefixes": (0.25, 1.0)},
    "topk_sae": {"topk": 4},
}
SWEEP_OPS = {
    "sae_mlp": (fused_sae.fused_sae_sweep_loss_terms, {}),
    "gated_sae": (fused_gated_sae.fused_gated_sweep_loss_terms, {}),
    "jumprelu_sae": (fused_jumprelu_sae.fused_jumprelu_sweep_loss_terms, {"bandwidth": 0.5}),
    "matryoshka_sae": (fused_matryoshka_sae.fused_matryoshka_sweep_loss_terms,
                       {"prefixes": (0.25, 1.0)}),
}


def _j_fused_loss(name):
    """JAX's fused loss terms of ``name`` at (a)'s interpret-mode options."""
    from sparse_vision_tpu.ops.fused_gated_sae import fused_gated_sae_loss_terms
    from sparse_vision_tpu.ops.fused_jumprelu_sae import fused_jumprelu_sae_loss_terms
    from sparse_vision_tpu.ops.fused_matryoshka_sae import fused_matryoshka_sae_loss_terms
    from sparse_vision_tpu.ops.fused_sae import fused_sae_loss_terms

    def loss(p, x, lam):
        if name == "gated_sae":
            return fused_gated_sae_loss_terms(p, x, lam, FEF, **J_FUSED)
        if name == "jumprelu_sae":
            return fused_jumprelu_sae_loss_terms(p, x, lam, FEF, bandwidth=0.5, **J_FUSED)
        if name == "matryoshka_sae":
            return fused_matryoshka_sae_loss_terms(p, x, lam, FEF, (0.25, 1.0), **J_FUSED)
        return fused_sae_loss_terms(p, x, lam, FEF, **J_FUSED)

    return loss


def _j_params(name, d, ef, seed):
    p = j_init_sae(name, jax.random.key(seed), d, ef, jumprelu_threshold_init=0.5)
    if name in ("sae_mlp", "topk_sae"):  # 8 latents that never fire: a resample has work
        p = {**p, "b_enc": p["b_enc"].at[:8].add(-100.0)}
    return p


def _stacked(trees):
    return {k: np.stack([np.asarray(t[k]) for t in trees]) for k in trees[0]}


@pytest.mark.parametrize("name", list(SWEEP_OPS))
def test_sweep_op_matches_jax_fused_op_under_vmap(name):
    """(a) Loss terms, dead masks, sparsity and gradients per combo."""
    x = np.random.default_rng(0).normal(size=(FT, FC)).astype(np.float32)
    jp = _stacked([jax.device_get(_j_params(name, FC, FEF, s)) for s in SEEDS])
    lams = np.asarray(LAMBDAS, np.float32)

    def jloss(p, xx, lam):
        out = _j_fused_loss(name)(p, xx, lam)
        return out["loss"], out

    (_, jout), jg = jax.vmap(jax.value_and_grad(jloss, has_aux=True), in_axes=(0, None, 0))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(lams))
    op, kw = SWEEP_OPS[name]
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in jp.items()}
    out = op(tp, torch.from_numpy(x), torch.from_numpy(lams), FEF, compute_dtype="float32", **kw)
    grads = torch.autograd.grad(out["loss"].sum(), list(tp.values()))
    for key in ("loss", "rec_loss", "l1_loss", "sparsity"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(out["dead"].numpy(), np.asarray(jout["dead"]))
    for k, g in zip(tp, grads):
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=k)


def _jax_resample_draws(step: int, seed: int, d: int, h: int, d_out=None):
    """The draws JAX's step makes at 1-based ``step`` for a combo whose key
    started at ``seed``: it splits its rng once a step, the resample splits the
    sub-key into (enc, dec)."""
    key = jax.random.key(seed)
    for _ in range(step):
        key, sub = jax.random.split(key)
    k_enc, k_dec = jax.random.split(sub)
    return (torch.from_numpy(np.array(kaiming_uniform(k_enc, (h, d), fan_in=d))),
            torch.from_numpy(np.array(kaiming_uniform(k_dec, (d_out or d, h), fan_in=h))))


def _sweep_pair(name, fused, optimizer, ndead, lambdas=LAMBDAS, lrs=LRS, seeds=SEEDS):
    """JAX's and the port's sweep states and steps on the same initial
    dictionaries: (jss, jstep, tss, tstep, d, h)."""
    d, ef = (FC, FEF) if fused else (SD, SEF)
    jstates, tstates = [], []
    for lr, sd in zip(lrs, seeds):
        jtx = joptim.get_optimizer(optimizer, lr)
        jts = jsteps.init_sae_train_state(_j_params(name, d, ef, sd), jtx, d * ef, seed=sd)
        jstates.append(jts)
        tstates.append(convert.train_state_from_jax(jax.device_get(jts), seed=sd))
    kw = VARIANT_KW[name]
    jstep = jsweep.make_sae_sweep_step(name, lambdas, lrs, optimizer, ndead, ef, fused=fused,
                                       fused_opts=J_FUSED if fused else None, **kw)
    tstep = tsweep.make_sae_sweep_step(name, lambdas, lrs, optimizer, ndead, ef, fused=fused,
                                       fused_opts=T_FUSED, **kw)
    return (jsweep.stack_sae_states(jstates), jstep, tsweep.stack_sae_states(tstates), tstep,
            d, d * ef)


def _check_states(tss, jss, params_tol=(2e-3, 2e-5)):
    for k in tss.params:
        np.testing.assert_allclose(tss.params[k].numpy(), np.asarray(jss.params[k]),
                                   rtol=params_tol[0], atol=params_tol[1], err_msg=k)
    np.testing.assert_array_equal(tss.dead_acc.numpy(), np.asarray(jss.dead_acc))
    assert tss.step == int(jss.step)


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
@pytest.mark.parametrize("name", list(VARIANT_KW))
def test_sweep_step_matches_jax(name, fused):
    """(b) sae_mlp across a reset (step 2) and a resample (step 5) with
    ConstrainedAdam, the others across the rolling window's restarts (steps 2
    and 4) with Adam, as tests/test_sweep_vmap.py runs them."""
    resamples = name == "sae_mlp"
    optimizer, steps = ("constrained_adam", 5) if resamples else ("adam", 4)
    jss, jstep, tss, tstep, d, h = _sweep_pair(name, fused, optimizer, 2)
    t = FT if fused else ST
    rng = np.random.default_rng(1)
    for i in range(1, steps + 1):
        x = rng.normal(size=(t, d)).astype(np.float32)
        jss, jm = jstep(jss, jnp.asarray(x))
        draws = [_jax_resample_draws(i, s, d, h) for s in SEEDS] if resamples and i == 5 else None
        tss, tm = tstep(tss, torch.from_numpy(x), resample_draws=draws)
        for key in ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=2e-4,
                                       atol=1e-7, err_msg=f"{key} at step {i}")
        np.testing.assert_array_equal(tss.dead_acc.numpy(), np.asarray(jss.dead_acc),
                                      err_msg=f"dead_acc at step {i}")
    _check_states(tss, jss)
    if resamples:  # the resample revived the never-firing latents of every combo
        assert float(tss.params["b_enc"][:, :8].min()) > -1.0


def _single_runs(name, fused, optimizer, ndead, batches):
    """The port's single-device step for each combo of (c): its final states."""
    out = []
    for lam, lr, sd in zip(LAMBDAS, LRS, SEEDS):
        d, ef = (FC, FEF) if fused else (SD, SEF)
        tx = toptim.get_optimizer(optimizer, lr)
        ts = convert.train_state_from_jax(
            jax.device_get(jsteps.init_sae_train_state(_j_params(name, d, ef, sd),
                                                       joptim.get_optimizer(optimizer, lr),
                                                       d * ef, seed=sd)), seed=sd)
        step = tsteps.make_sae_train_step_from_acts(name, lam, tx, ndead, ef, fused=fused,
                                                    fused_opts=T_FUSED, **VARIANT_KW[name])
        for x in batches:
            ts, m = step(ts, torch.from_numpy(x))
        out.append((ts, m))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
@pytest.mark.parametrize("name", list(VARIANT_KW))
def test_sweep_step_equals_single_device_steps(name, fused):
    """(c) The sweep against N runs of the port's own step (sae_mlp across a
    resample drawn from each combo's generator, the others across the rolling
    window's restarts)."""
    resamples = name == "sae_mlp"
    optimizer = "constrained_adam" if resamples else "adam"
    _, _, tss, tstep, d, _ = _sweep_pair(name, fused, optimizer, 2)
    t = FT if fused else ST
    rng = np.random.default_rng(2)
    batches = [rng.normal(size=(t, d)).astype(np.float32) for _ in range(5)]
    for x in batches:
        tss, tm = tstep(tss, torch.from_numpy(x))
    bitwise = fused and name != "topk_sae"  # the fused sweep op's plain versions
    # the stock vmap: batched products; the TopK sweep's stock math against the
    # single step's fast path (its gather decode): other orders of summation
    rtol, atol = (1e-4, 1e-6) if name == "topk_sae" and fused else (1e-6, 1e-7)
    for i, (ts, m) in enumerate(_single_runs(name, fused, optimizer, 2, batches)):
        si = tsweep.unstack_sae_state(tss, i)
        for k in ts.params:
            if bitwise:
                assert torch.equal(si.params[k], ts.params[k]), f"combo {i} {k}"
            else:
                np.testing.assert_allclose(si.params[k].numpy(), ts.params[k].numpy(),
                                           rtol=rtol, atol=atol, err_msg=f"combo {i} {k}")
        assert torch.equal(si.dead_acc, ts.dead_acc)
        # not perc_dead: the sweep reads it before the reset at step 4 (as JAX's
        # sweep does), the single step after it
        for key in ("sae_loss", "sae_rec_loss", "sparsity"):
            np.testing.assert_allclose(float(tm[key][i]), float(m[key]), rtol=1e-6, err_msg=key)


def test_transcoder_sweep_step_matches_jax():
    """(d) The transcoder sweep (ConstrainedAdam, d_in 16 -> d_out 24) across a
    reset and the resample at step 5, JAX's draws injected."""
    d_in, d_out, ef = 16, 24, 4
    h = d_in * ef
    jstates, tstates = [], []
    for lr, sd in zip(LRS, SEEDS):
        p = j_init_transcoder(jax.random.key(sd), d_in, ef, d_out)
        p = {**p, "b_enc": p["b_enc"].at[:8].add(-100.0)}
        jts = jsteps.init_sae_train_state(p, joptim.get_optimizer("constrained_adam", lr), h,
                                          seed=sd)
        jstates.append(jts)
        tstates.append(convert.train_state_from_jax(jax.device_get(jts), seed=sd))
    jss, tss = jsweep.stack_sae_states(jstates), tsweep.stack_sae_states(tstates)
    jstep = jsweep.make_transcoder_sweep_step(LAMBDAS, LRS, "constrained_adam", 2, ef)
    tstep = tsweep.make_transcoder_sweep_step(LAMBDAS, LRS, "constrained_adam", 2, ef)
    rng = np.random.default_rng(3)
    for i in range(1, 6):
        x = rng.normal(size=(ST, d_in)).astype(np.float32)
        y = rng.normal(size=(ST, d_out)).astype(np.float32)
        jss, jm = jstep(jss, jnp.asarray(x), jnp.asarray(y))
        draws = [_jax_resample_draws(i, s, d_in, h, d_out) for s in SEEDS] if i == 5 else None
        tss, tm = tstep(tss, torch.from_numpy(x), torch.from_numpy(y), resample_draws=draws)
        np.testing.assert_allclose(tm["sae_loss"].numpy(), np.asarray(jm["sae_loss"]),
                                   rtol=2e-4)
    _check_states(tss, jss)
    assert float(tss.params["b_enc"][:, :8].min()) > -1.0


def _jax_crosscoder_draws(step: int, seed: int, dims: tuple, h: int):
    """The draws JAX's crosscoder step makes at 1-based ``step``
    (resample_dead_neurons_crosscoder: two keys a layer)."""
    key = jax.random.key(seed)
    for _ in range(step):
        key, sub = jax.random.split(key)
    keys = jax.random.split(sub, 2 * len(dims))
    return [(torch.from_numpy(np.array(kaiming_uniform(keys[2 * i], (h, d), fan_in=d))),
             torch.from_numpy(np.array(kaiming_uniform(keys[2 * i + 1], (d, h), fan_in=h))))
            for i, d in enumerate(dims)]


def test_crosscoder_sweep_step_matches_jax():
    """(d) The crosscoder sweep (Adam, layers 8 / 12 / 20) across a reset and
    the resample at step 5, JAX's draws injected; ConstrainedAdam refused as
    in JAX."""
    dims, ef = (8, 12, 20), 8
    h = dims[0] * ef
    jstates, tstates = [], []
    for lr, sd in zip(LRS, SEEDS):
        p = j_init_crosscoder(jax.random.key(sd), dims, ef)
        p = {**p, "b_enc": p["b_enc"].at[:8].add(-100.0)}
        jts = jsteps.init_sae_train_state(p, joptim.get_optimizer("adam", lr), h, seed=sd)
        jstates.append(jts)
        tstates.append(convert.train_state_from_jax(jax.device_get(jts), seed=sd))
    jss, tss = jsweep.stack_sae_states(jstates), tsweep.stack_sae_states(tstates)
    jstep = jsweep.make_crosscoder_sweep_step(LAMBDAS, LRS, "adam", 2, ef)
    tstep = tsweep.make_crosscoder_sweep_step(LAMBDAS, LRS, "adam", 2, ef)
    rng = np.random.default_rng(4)
    for i in range(1, 6):
        xs = tuple(rng.normal(size=(ST, d)).astype(np.float32) for d in dims)
        jss, jm = jstep(jss, tuple(jnp.asarray(x) for x in xs))
        draws = [_jax_crosscoder_draws(i, s, dims, h) for s in SEEDS] if i == 5 else None
        tss, tm = tstep(tss, tuple(torch.from_numpy(x) for x in xs), resample_draws=draws)
        np.testing.assert_allclose(tm["sae_loss"].numpy(), np.asarray(jm["sae_loss"]),
                                   rtol=2e-4)
    _check_states(tss, jss)
    for mod in (jsweep, tsweep):
        with pytest.raises(ValueError, match="plain optimizer"):
            mod.make_crosscoder_sweep_step(LAMBDAS, LRS, "constrained_adam", 2, ef)


# ---------------------------------------------------------------------------
# (e) the cached trainers end to end
# ---------------------------------------------------------------------------

E2E = dict(model_name="custom_mlp_9", sae_model_name="sae_mlp", sae_layer="fc1",
           dataset_name="synthetic", batch_size=64, sae_epochs=2, sae_learning_rate=1e-3,
           sae_optimizer_name="constrained_adam", sae_batch_size=64, sae_lambda_sparse=0.1,
           sae_expansion_factor=2, dead_neurons_steps=10_000, log_every=1000,
           use_activation_cache=True, cache_tokens_per_step=64, cache_dtype="float32",
           compute_dtype="float32", seed=0)
E2E_OVERRIDES = [{"sae_lambda_sparse": 0.05}, {"sae_lambda_sparse": 0.3, "sae_learning_rate": 2e-3}]
# sae_model_name -> config fields beyond E2E
E2E_RUNS = {
    "sae_mlp": {},
    "transcoder": {"transcoder_target_layer": "fc2"},
    "crosscoder": {"crosscoder_layers": "act1,fc2", "sae_optimizer_name": "adam",
                   "sae_lambda_sparse": 0.02},
}


def _e2e_datasets(make):
    tr = make(num_samples=256, img_size=(28, 28, 1), num_classes=10, seed=5)
    va = make(num_samples=64, img_size=(28, 28, 1), num_classes=10, seed=6)
    return tr, va, tr.category_names, (28, 28, 1)


def _jax_weights(monkeypatch):
    """The port's Pipelines draw JAX's initial backbone and dictionary for their
    seed (JAX's Pipeline: key(seed) split into the backbone's and the
    dictionary's keys)."""
    def keys(gen):
        return jax.random.split(jax.random.key(gen.initial_seed()))

    def init_backbone(net, gen, dataset_name):
        jnet = j_backbone.make_backbone(E2E["model_name"], dataset_name)
        return convert.backbone_from_jax(*jax.device_get(
            j_backbone.init_backbone(jnet, keys(gen)[0], dataset_name)))

    def init_sae(name, gen, d, ef, **kw):
        return convert.sae_params_from_jax(jax.device_get(j_init_sae(name, keys(gen)[1], d, ef,
                                                                     **kw)))

    def init_transcoder(gen, d_in, ef, d_out):
        return convert.sae_params_from_jax(jax.device_get(
            j_init_transcoder(keys(gen)[1], d_in, ef, d_out)))

    def init_crosscoder(gen, dims, ef):
        return convert.sae_params_from_jax(jax.device_get(
            j_init_crosscoder(keys(gen)[1], dims, ef)))

    monkeypatch.setattr(tpipeline, "init_backbone", init_backbone)
    monkeypatch.setattr(tpipeline, "init_sae", init_sae)
    monkeypatch.setattr(tpipeline, "init_transcoder", init_transcoder)
    monkeypatch.setattr(tpipeline, "init_crosscoder", init_crosscoder)


def _rows(folder: str) -> list:
    with open(os.path.join(folder, "sae_eval_results.csv")) as f:
        return sorted(csv.DictReader(f), key=lambda r: (r["epochs"], r["lambda_sparse"]))


@pytest.fixture(scope="module", params=list(E2E_RUNS))
def e2e(request, tmp_path_factory):
    """Both packages' cached sweep trainers on E2E plus the run's fields:
    (fields, JAX's last evals, the port's, the port's Pipelines, JAX's folder)."""
    mp = pytest.MonkeyPatch()
    _jax_weights(mp)
    try:
        fields = {**E2E, "sae_model_name": request.param, **E2E_RUNS[request.param]}
        jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
        with quick_jax_pipeline():  # no matplotlib figures: nothing here reads them
            jlast = jsweep.train_sae_sweep_cached(
                jconfig.RunConfig(**fields, directory_path=str(jdir)), E2E_OVERRIDES,
                datasets=_e2e_datasets(j_synth))
        pipes: list = []
        tlast = tsweep.train_sae_sweep_cached(
            tconfig.RunConfig(**fields, directory_path=str(tdir)), E2E_OVERRIDES,
            datasets=_e2e_datasets(t_synth), device="cpu", pipelines=pipes)
    finally:
        mp.undo()
    return fields, jlast, tlast, pipes, jdir


def test_cached_sweep_final_evals_match_jax(e2e):
    fields, jlast, tlast, pipes, _ = e2e
    assert len(tlast) == len(jlast) == len(E2E_OVERRIDES)
    for j, t in zip(jlast, tlast):
        for k in ("sae_rec_loss", "sae_loss", "sparsity", "perc_dead_units", "accuracy"):
            np.testing.assert_allclose(t[k], float(j[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    # each combo trained with its own λ and learning rate, from one backbone
    for p, ov in zip(pipes, E2E_OVERRIDES):
        assert p.cfg.sae_lambda_sparse == ov["sae_lambda_sparse"]
        assert p.frozen_params is pipes[0].frozen_params
        assert [s for s, _ in p.train_log] == list(range(1, 9))  # 4 steps an epoch


def test_cached_sweep_checkpoints_match_jax(e2e):
    fields, _, _, pipes, jdir = e2e
    for p, ov in zip(pipes, E2E_OVERRIDES):
        jcfg = jconfig.RunConfig(**{**fields, **ov}, directory_path=str(jdir),
                                 sae_checkpoint_epoch=2)
        jp = JPipeline(jcfg, datasets=_e2e_datasets(j_synth))  # restores JAX's epoch 2
        tree = tckpt.load_checkpoint(p._sae_ckpt_dir(), 2)
        assert tree["step"] == int(jp.ts.step) == 8
        for k, v in tree["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp.ts.params[k]), rtol=2e-3,
                                       atol=2e-5, err_msg=k)


def test_cached_sweep_results_rows_match_jax(e2e):
    fields, _, _, pipes, jdir = e2e
    jfolder = JPipeline(jconfig.RunConfig(**fields, directory_path=str(jdir)),
                        datasets=_e2e_datasets(j_synth)).paths["evaluation_results"]
    jrows, trows = _rows(jfolder), _rows(pipes[0].paths["evaluation_results"])
    assert [(r["epochs"], r["lambda_sparse"]) for r in trows] == \
        [(r["epochs"], r["lambda_sparse"]) for r in jrows]
    assert len(trows) == 2 * len(E2E_OVERRIDES)
    for jr, tr in zip(jrows, trows):
        for k in ("rec_loss", "l1_loss", "var_expl", "perc_dead_units"):
            np.testing.assert_allclose(float(tr[k]), float(jr[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    if fields["sae_model_name"] == "crosscoder":  # each combo's decoder-norm CSV
        for p in pipes:
            name = os.path.basename(p.decoder_norms_path)
            jpath = os.path.join(JPipeline(
                jconfig.RunConfig(**{**fields, **E2E_OVERRIDES[pipes.index(p)]},
                                  directory_path=str(jdir)),
                datasets=_e2e_datasets(j_synth)).paths["sae_weights"], name)
            with open(jpath) as f, open(p.decoder_norms_path) as g:
                jcsv, tcsv = list(csv.reader(f)), list(csv.reader(g))
            assert jcsv[0] == tcsv[0] and len(jcsv) == len(tcsv)
            np.testing.assert_allclose(np.array(tcsv[1:], float), np.array(jcsv[1:], float),
                                       rtol=2e-3, atol=2e-5)


def test_a_resumed_sweep_equals_a_straight_one(tmp_path):
    """Epoch 1, then a sweep resumed from its checkpoints (sae_checkpoint_epoch
    1), against two straight epochs: the same final parameters, bitwise (no
    resample fires, so the generators' restart does not show: ROADMAP C.3)."""
    base = tconfig.RunConfig(**E2E, directory_path=str(tmp_path / "a"))
    straight: list = []
    tsweep.train_sae_sweep_cached(base, E2E_OVERRIDES, datasets=_e2e_datasets(t_synth),
                                  device="cpu", pipelines=straight)
    first = dataclasses.replace(base, directory_path=str(tmp_path / "b"), sae_epochs=1)
    tsweep.train_sae_sweep_cached(first, E2E_OVERRIDES, datasets=_e2e_datasets(t_synth),
                                  device="cpu")
    resumed: list = []
    tsweep.train_sae_sweep_cached(dataclasses.replace(first, sae_epochs=2,
                                                      sae_checkpoint_epoch=1),
                                  E2E_OVERRIDES, datasets=_e2e_datasets(t_synth), device="cpu",
                                  pipelines=resumed)
    for a, b in zip(straight, resumed):
        assert a.ts.step == b.ts.step == 8
        for k in a.ts.params:
            assert torch.equal(a.ts.params[k], b.ts.params[k]), k


# ---------------------------------------------------------------------------
# (f) grouping and the overrides' rules
# ---------------------------------------------------------------------------

def _both(**kw):
    return tconfig.RunConfig(**{**E2E, **kw}), jconfig.RunConfig(**{**E2E, **kw})


GROUP_CASES = {
    # tests/test_sweep_vmap.py's partition case
    "partition": [{"sae_lambda_sparse": 0.1}, {"sae_lambda_sparse": 0.2}, {"training": False},
                  {"sae_expansion_factor": 4},
                  {"sae_lambda_sparse": 0.3, "sae_learning_rate": 2e-3}],
    # seeds alone collide on the run identity: one by one
    "seeds": [{"seed": 0}, {"seed": 1}, {"seed": 2}],
    "refused": [{"sae_model_name": "batch_topk_sae", "sae_lambda_sparse": 0.1},
                {"sae_model_name": "batch_topk_sae", "sae_lambda_sparse": 0.2},
                {"overlap_dump_train": True, "sae_lambda_sparse": 0.1},
                {"overlap_dump_train": True, "sae_lambda_sparse": 0.2},
                {"use_activation_cache": False, "sae_lambda_sparse": 0.1},
                {"use_activation_cache": False, "sae_lambda_sparse": 0.2}],
    "coders": [{"sae_model_name": "transcoder", "transcoder_target_layer": "fc2",
                "sae_lambda_sparse": lam, "mesh_shape": mesh}
               for mesh in ((), (2,)) for lam in (0.1, 0.2)],
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_group_sweepable_matches_jax(case):
    pairs = [_both(**kw) for kw in GROUP_CASES[case]]
    tg, ts = tsweep.group_sweepable([t for t, _ in pairs])
    jg, js = jsweep.group_sweepable([j for _, j in pairs])
    assert [(json.loads(b.to_json()), ov) for b, ov in tg] == \
        [(json.loads(b.to_json()), ov) for b, ov in jg]
    assert [json.loads(c.to_json()) for c in ts] == [json.loads(c.to_json()) for c in js]


@pytest.mark.parametrize("base_kw,overrides", [
    ({}, []),
    ({}, [{"sae_expansion_factor": 4}]),
    ({"training": False}, [{"seed": 1}]),
    ({"overlap_dump_train": True}, [{"seed": 1}]),
])
def test_validate_overrides_refuses_as_jax(base_kw, overrides):
    t, j = _both(**base_kw)
    with pytest.raises(ValueError) as t_err:
        tsweep._validate_overrides(t, overrides)
    with pytest.raises(ValueError) as j_err:
        jsweep._validate_overrides(j, overrides)
    assert str(t_err.value).split(" (")[0] == str(j_err.value).split(" (")[0]


def test_the_sweep_refuses_a_mesh_naming_a6_and_batch_topk(tmp_path):
    t, _ = _both(directory_path=str(tmp_path), mesh_shape=(2,))
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tsweep.train_sae_sweep_cached(t, E2E_OVERRIDES, datasets=_e2e_datasets(t_synth),
                                      device="cpu")
    with pytest.raises(ValueError, match="not vmap-sweepable"):
        tsweep.train_sae_sweep_cached(dataclasses.replace(t, sae_model_name="batch_topk_sae"),
                                      E2E_OVERRIDES, device="cpu")


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------

def _record(monkeypatch) -> list:
    """Replace the sweep trainer and Pipeline.run by recorders: [(kind, ...)]."""
    calls: list = []

    def sweep(base, overrides, device=None, **kw):
        calls.append(("sweep", base, list(overrides), device))
        return [{"combo": i} for i in range(len(overrides))]

    def run(self):
        calls.append(("run", self.cfg))
        return {"ran": self.cfg.sae_lambda_sparse}

    monkeypatch.setattr(tsweep, "train_sae_sweep_cached", sweep)
    monkeypatch.setattr(tpipeline.Pipeline, "__init__",
                        lambda self, cfg, device=None, **kw: setattr(self, "cfg", cfg))
    monkeypatch.setattr(tpipeline.Pipeline, "run", run)
    return calls


def _jsonl(path, entries):
    with open(path, "w") as f:
        for kw in entries:
            f.write(tconfig.RunConfig(**{**E2E, **kw}).to_json() + "\n")
    return str(path)


def test_cli_vmap_sweep_groups_the_jsonl_and_runs_the_rest(tmp_path, monkeypatch, capsys):
    calls = _record(monkeypatch)
    path = _jsonl(tmp_path / "s.jsonl", GROUP_CASES["partition"])
    out = tcli.main(["--run_pipeline", "--parameters", path, "--vmap_sweep", "--device", "cpu"])
    groups, singles = jsweep.group_sweepable(jconfig.read_jsonl(path))
    assert [c[0] for c in calls] == ["sweep", "run", "run"]
    assert calls[0][2] == groups[0][1] and calls[0][3] == "cpu"
    assert [c[1].to_json() for c in calls[1:]] == [c.to_json() for c in singles]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["results"][0]["last_evals"] == [{"combo": i} for i in range(3)]


def test_cli_without_vmap_sweep_runs_every_entry_and_line_picks_one(tmp_path, monkeypatch):
    calls = _record(monkeypatch)
    path = _jsonl(tmp_path / "s.jsonl", GROUP_CASES["partition"])
    tcli.main(["--run_pipeline", "--parameters", path, "--device", "cpu"])
    assert [c[0] for c in calls] == ["run"] * 5
    calls.clear()
    out = tcli.main(["--run_pipeline", "--parameters", path, "--line", "3", "--vmap_sweep"])
    assert [c[0] for c in calls] == ["run"] and calls[0][1].sae_expansion_factor == 4
    assert out["results"][0]["result"] == {"ran": 0.1}


@pytest.mark.parametrize("fields", [24, 17])
def test_cli_reads_legacy_files_as_jax(fields, tmp_path, monkeypatch):
    """parameters.txt (24 fields) and parameters_eval.txt (17) lines, parsed
    as JAX's _load_parameters parses them and run one by one."""
    calls = _record(monkeypatch)
    cfgs = [jconfig.RunConfig(sae_lambda_sparse=lam, training=fields == 24)
            for lam in (0.1, 0.2)]
    path = tmp_path / "parameters.txt"
    path.write_text("".join((c.to_legacy_line() if fields == 24 else c.to_legacy_eval_line())
                            + "\n" for c in cfgs))
    from sparse_vision_tpu.cli import _load_parameters as j_load

    tcli.main(["--run_pipeline", "--parameters", str(path), "--vmap_sweep"])
    want = j_load(str(path))
    assert [json.loads(c[1].to_json()) for c in calls] == [json.loads(c.to_json()) for c in want]


def test_cli_refuses_both_or_neither_source(tmp_path):
    path = _jsonl(tmp_path / "s.jsonl", [{}])
    for argv in (["--run_pipeline"], ["--run_pipeline", "--parameters", path, "--config", "{}"],
                 ["--run_pipeline", "--config", "{}", "--vmap_sweep"],
                 ["--run_pipeline", "--parameters", path, "--mesh_shape", "2"]):
        with pytest.raises(SystemExit):
            tcli.main(argv)


def test_cli_trains_a_sweep_file_end_to_end(tmp_path, capsys):
    """A real --vmap_sweep run on the CPU: one group of two combos through
    train_sae_sweep_cached, each with its checkpoints and export."""
    path = _jsonl(tmp_path / "s.jsonl", [{"directory_path": str(tmp_path), "sae_epochs": 1,
                                          "sae_lambda_sparse": lam} for lam in (0.05, 0.3)])
    out = tcli.main(["--run_pipeline", "--parameters", path, "--vmap_sweep", "--device", "cpu"])
    (group,) = out["results"]
    assert group["vmap_sweep"] == [{"sae_lambda_sparse": lam, "sae_learning_rate": 1e-3,
                                    "seed": 0} for lam in (0.05, 0.3)]
    assert len(group["last_evals"]) == 2
    assert all(np.isfinite(e["sae_rec_loss"]) for e in group["last_evals"])
    for lam in (0.05, 0.3):
        cfg = tconfig.RunConfig(**{**E2E, "directory_path": str(tmp_path), "sae_epochs": 1,
                                   "sae_lambda_sparse": lam})
        from sparse_vision_tpu_torch.utils.paths import folder_paths, sae_run_name

        ck = os.path.join(folder_paths(cfg)["checkpoints"], sae_run_name(cfg))
        assert tckpt.latest_epoch(ck) == 1
        assert os.path.exists(os.path.join(folder_paths(cfg)["sae_weights"],
                                           f"{sae_run_name(cfg)}_model_weights.npz"))
