"""SAE train and eval steps (port of the sae_mlp, gated_sae, jumprelu_sae and
matryoshka_sae parts of sparse_vision_tpu/train/steps.py).

The JAX package jits one pure step over an explicit train state; here a step is
an eager function over the same state: gradients of the variant's loss by
autograd (through the fused op's autograd.Function when ``fused``), the
ConstrainedAdam or Adam update, the dead-latent accumulator, and either the
scheduled resample/reset (sae_mlp) or the rolling dead window (the variants
that do not resample). The step counter is a host integer, so the schedule
needs no device sync. The transcoder and crosscoder steps (train/transcoder.py,
train/crosscoder.py) share this update skeleton (make_train_step) and the eval
metrics (eval_metrics). An int8 cache's activations are dequantized on the
device by the wrappers make_dequant_step_fn and make_sae_train_multi_step_quant.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    JUMPRELU_BANDWIDTH,
    PORTED,
    matryoshka_prefix_counts,
    sae_inference_and_loss,
)
from sparse_vision_tpu_torch.ops import metrics, optim
from sparse_vision_tpu_torch.ops.resample import (
    kaiming_draws,
    resample_dead_neurons,
    should_reset_measurement,
    should_resample,
)


class SAETrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: int  # completed train batches (train_batch_idx)
    dead_acc: torch.Tensor  # bool [h]: running AND across batches since the last reset
    rng: torch.Generator  # draws of the resamples, on the parameters' device


def init_sae_train_state(sae_params: dict, tx: optim.Optimizer, hidden: int,
                         seed: int = 0) -> SAETrainState:
    device = next(iter(sae_params.values())).device
    return SAETrainState(
        params=sae_params,
        opt_state=tx.init(sae_params),
        step=0,
        dead_acc=torch.ones((hidden,), dtype=torch.bool, device=device),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def fused_op(sae_model_name: str,
             matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES) -> tuple:
    """(can_fuse(t, h, c, dtype), loss_terms(params, x, λ, expansion_factor,
    **opts)) of the variant's fused op: ops/fused_sae.py, ops/fused_gated_sae.py,
    ops/fused_jumprelu_sae.py or ops/fused_matryoshka_sae.py (with the prefix
    fractions bound)."""
    from sparse_vision_tpu_torch.ops import (
        fused_gated_sae,
        fused_jumprelu_sae,
        fused_matryoshka_sae,
        fused_sae,
    )

    if sae_model_name == "matryoshka_sae":
        prefixes = tuple(matryoshka_prefixes)

        def can_fuse(t, h, c=256, dtype=torch.bfloat16):
            return fused_matryoshka_sae.can_fuse_matryoshka(
                t, h, matryoshka_prefix_counts(h, prefixes), c, dtype)

        return can_fuse, functools.partial(
            fused_matryoshka_sae.fused_matryoshka_sae_loss_terms, prefixes=prefixes)

    return {
        "sae_mlp": (fused_sae.can_fuse, fused_sae.fused_sae_loss_terms),
        "gated_sae": (fused_gated_sae.can_fuse, fused_gated_sae.fused_gated_sae_loss_terms),
        "jumprelu_sae": (fused_jumprelu_sae.can_fuse,
                         fused_jumprelu_sae.fused_jumprelu_sae_loss_terms),
    }[sae_model_name]


def make_sae_train_step_from_acts(sae_model_name: str, lambda_sparse: float,
                                  tx: optim.Optimizer, dead_neurons_steps: int,
                                  expansion_factor: int, fused: bool = False,
                                  fused_opts: Optional[dict] = None,
                                  jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                                  matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES):
    """SAE train step over pre-extracted activations [T, C] (the activation-cache
    training mode) for sae_mlp, gated_sae, jumprelu_sae and matryoshka_sae.

    ``fused=True`` routes forward, loss and statistics through the variant's
    fused op (``fused_op``): the CUDA kernels on a CUDA tensor, their plain
    versions on a CPU tensor.
    ``fused_opts`` may set ``compute_dtype``, and ``bandwidth`` for jumprelu_sae
    (the stock path reads ``jumprelu_bandwidth``). ``matryoshka_prefixes`` are
    matryoshka_sae's prefix fractions, on both paths.

    The returned ``step_fn(ts, act, resample_draws=None) -> (ts, metrics)``
    (make_train_step) resamples (sae_mlp only) with Kaiming draws from ``ts.rng``
    unless ``resample_draws`` = (enc [h, d], dec [d, h]) is given (tests inject
    the JAX package's draws). The variants that do not resample use the rolling
    dead window instead."""
    if sae_model_name not in PORTED:
        raise NotImplementedError(f"SAE {sae_model_name!r} is not ported {PORTED}")
    if fused:
        _, fused_loss_terms = fused_op(sae_model_name, matryoshka_prefixes)

        def loss_fn(params, act):
            return fused_loss_terms(params, act, lambda_sparse, expansion_factor,
                                    **(fused_opts or {}))
    else:
        def loss_fn(params, act):
            return sae_inference_and_loss(sae_model_name, params, act, lambda_sparse,
                                          jumprelu_bandwidth=jumprelu_bandwidth,
                                          matryoshka_prefixes=matryoshka_prefixes)

    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, fused,
                           resample_sae if sae_model_name == "sae_mlp" else None)


def resample_sae(params: dict, opt_state: dict, dead: torch.Tensor, rng: torch.Generator,
                 draws=None):
    """resample_dead_neurons with Kaiming draws from ``rng`` unless ``draws`` =
    (enc [h, d], dec [d_out, h]) is given; d_out is W_dec's width, so the
    transcoder's rectangular decoder takes the same surgery."""
    if draws is None:
        d, h = params["W_enc"].shape
        draws = kaiming_draws(rng, d, h, params["W_dec"].shape[1])
    return resample_dead_neurons(params, opt_state, dead, *draws)


def make_train_step(loss_fn, tx: optim.Optimizer, dead_neurons_steps: int,
                    expansion_factor: int, fused: bool, resample=None):
    """The update skeleton shared by the SAE, transcoder and crosscoder steps:
    ``step_fn(ts, *acts, resample_draws=None) -> (ts, metrics)`` takes the
    gradient of ``loss_fn(params, *acts)["loss"]``, applies the optimizer and
    updates the dead-latent accumulator (from the fused op's ``dead`` when
    ``fused``, else from ``encoded``). ``resample(params, opt_state, dead_acc,
    rng, draws)`` runs on the schedule of ops/resample.should_resample, with
    measurement resets between; with ``resample=None`` the accumulator is the
    rolling window instead, restarting all-True every ``dead_neurons_steps``
    steps.

    Reproduced quirk: ``perc_dead`` is read AFTER the reset/resample branch, so at
    a measurement boundary it reports the freshly reset all-True accumulator
    (100% dead), exactly as the JAX step does (ROADMAP queue C)."""

    def step_fn(ts: SAETrainState, *acts, resample_draws=None):
        keys = list(ts.params)
        params = {k: v.detach().requires_grad_(True) for k, v in ts.params.items()}
        out = loss_fn(params, *acts)
        loss = out["loss"]
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        with torch.no_grad():
            grads = dict(zip(keys, grads))
            updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
            new_params = optim.apply_updates(ts.params, updates)
            step = ts.step + 1
            if fused:
                dead, sparsity = out["dead"], out["sparsity"]
            else:
                dead, sparsity, _ = metrics.measure_inactive_units(
                    out["encoded"], expansion_factor)
            dead_acc = ts.dead_acc & dead
            if resample is None:
                # rolling dead window (the JAX step's non-resampling branch)
                if step % dead_neurons_steps == 0:
                    dead_acc = torch.ones_like(dead_acc)
            elif should_resample(step, dead_neurons_steps):
                new_params, opt_state = resample(new_params, opt_state, dead_acc, ts.rng,
                                                 resample_draws)
                dead_acc = torch.ones_like(dead_acc)
            elif should_reset_measurement(step, dead_neurons_steps):
                dead_acc = torch.ones_like(dead_acc)
            m = {
                "sae_loss": loss.detach(),
                "sae_rec_loss": out["rec_loss"].detach(),
                "sae_l1_loss": out["l1_loss"].detach(),
                "sparsity": sparsity,
                "perc_dead": dead_acc.sum() / dead_acc.shape[0],
            }
        return SAETrainState(new_params, opt_state, step, dead_acc, ts.rng), m

    return step_fn


def make_sae_train_multi_step(step_fn):
    """Run a ``(ts, *acts) -> (ts, metrics)`` step over stacked [K, T, C]
    microbatch sequences, one stack per step argument (the transcoder's step
    takes two); metrics come back stacked [K]. A Python loop: the JAX package's
    lax.scan dispatch, with CUDA graphs left for later."""

    def multi(ts: SAETrainState, *stacks: torch.Tensor):
        ms = []
        for acts in zip(*stacks):
            ts, m = step_fn(ts, *acts)
            ms.append(m)
        return ts, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return multi


def make_dequant_step_fn(step_fn, compute_dtype=torch.float32):
    """``step_q(ts, q [T, C] int8, scale [C]) -> (ts, metrics)``: ``step_fn`` on
    int8-quantized activations, dequantized on the device, ``q.to(dtype) *
    scale`` (data/activation_cache.quantize_int8 wrote the shards; an int8 cache
    moves one byte an element to the device)."""

    def step_q(ts: SAETrainState, q: torch.Tensor, scale: torch.Tensor):
        return step_fn(ts, q.to(compute_dtype) * scale.to(compute_dtype))

    return step_q


def make_sae_train_multi_step_quant(step_fn, compute_dtype=torch.float32):
    """The quantized twin of make_sae_train_multi_step: ``multi(ts, q_stack [K,
    T, C] int8, scale [C])``, each step dequantized on the device as
    make_dequant_step_fn does (a stack never spans shards, so one scale serves
    it); metrics stacked [K]."""
    step_q = make_dequant_step_fn(step_fn, compute_dtype)

    def multi(ts: SAETrainState, q_stack: torch.Tensor, scale: torch.Tensor):
        return make_sae_train_multi_step(lambda ts, q: step_q(ts, q, scale))(ts, q_stack)

    return multi


def make_sae_eval_step(net, sae_layer: str, sae_model_name: str, lambda_sparse: float,
                       expansion_factor: int, criterion,
                       jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                       matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                       input_scale: Optional[float] = None):
    """Eval step for the SAE-spliced model: the reference's eval-epoch quantities
    for one batch (model_pipeline.py:661-714 + 806-878), in plain torch (the JAX
    eval is stock XLA too). Returns (batch_metrics, arrays) with arrays 'dead',
    'freq' and 'correct'.

    ``input_scale`` (sae_input_norm="rms"): the SAE reads ``act / scale`` and
    the splice rescales the reconstruction back, so KLD, %same and loss_diff
    are those of the raw model, while rec, l1 and rmse report on the normalized
    basis the dictionary trained on."""
    last = net.stage_names[-1]
    inv = None if input_scale is None else float(1.0 / input_scale)

    @torch.no_grad()
    def step_fn(sae_params, frozen_params, frozen_state, images, labels):
        logits_orig, taps, _ = net.apply(frozen_params, images, state=frozen_state)
        act = taps[sae_layer]
        if inv is not None:
            act = act * inv
        out = sae_inference_and_loss(sae_model_name, sae_params, act, lambda_sparse,
                                     jumprelu_bandwidth=jumprelu_bandwidth,
                                     matryoshka_prefixes=matryoshka_prefixes)
        decoded = out["decoded"] if inv is None else out["decoded"] * float(input_scale)
        logits_mod = net.apply_segment(frozen_params, decoded, after=sae_layer,
                                       upto=last, state=frozen_state)
        return eval_metrics(out, act, out["decoded"], logits_orig, logits_mod, labels,
                            criterion, expansion_factor)

    return step_fn


def eval_metrics(out: dict, act: torch.Tensor, decoded: torch.Tensor, logits_orig,
                 logits_mod, labels, criterion, expansion_factor: int):
    """(batch_metrics, arrays) of one eval batch of a spliced dictionary, from its
    loss terms ``out`` and the logits of the original and the modified model;
    ``var_expl`` is that of the spliced activation ``act`` by ``decoded``."""
    loss_mod = criterion(logits_mod, labels)
    loss_orig = criterion(logits_orig, labels)
    dead, sparsity, freq = metrics.measure_inactive_units(out["encoded"], expansion_factor)
    batch_metrics = {
        "model_loss": loss_mod,
        "loss_diff": loss_mod - loss_orig,
        "accuracy": metrics.accuracy(logits_mod, labels),
        "kld": metrics.kld_original_vs_modified(logits_orig, logits_mod),
        "perc_same": metrics.perc_same_classification(logits_orig, logits_mod),
        "sae_loss": out["loss"],
        "sae_rec_loss": out["rec_loss"],
        "sae_l1_loss": out["l1_loss"],
        "sae_nrmse_loss": out["nrmse_loss"],
        "sae_rmse_loss": out["rmse_loss"],
        "sae_aux_loss": out["aux_loss"],
        "sparsity": sparsity,
        "var_expl": metrics.variance_explained(act, decoded),
    }
    arrays = {
        "dead": dead,
        "freq": freq,
        "correct": (logits_mod.argmax(1) == labels).sum(),
    }
    return batch_metrics, arrays
