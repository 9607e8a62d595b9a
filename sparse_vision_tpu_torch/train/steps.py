"""Train and eval steps (port of sparse_vision_tpu/train/steps.py): the SAE
steps for every variant (sae_mlp, gated_sae, jumprelu_sae, matryoshka_sae,
topk_sae, batch_topk_sae and sae_conv), and the original model's own
(make_model_train_step, make_model_eval_step).

Two training modes, as in the JAX package: from cached activations
(make_sae_train_step_from_acts, on the fused ops or the TopK fast paths) and
without a cache (make_sae_train_step: the frozen backbone, the tap, the update
on the stock SAE math, the splice's full metrics). The JAX package jits one
pure step over an explicit train state; here a step is an eager function over
the same state: gradients of the variant's loss by autograd (through the fused
op's autograd.Function when ``fused``), the ConstrainedAdam or Adam update, the
dead-latent accumulator, and either the scheduled resample/reset (sae_mlp) or
the rolling dead window (the variants that do not resample); the TopK family's
AuxK term and batch_topk's threshold EMA ride on the same update. The step
counter is a host integer, so the schedule needs no device sync. The
transcoder and crosscoder steps (train/transcoder.py, train/crosscoder.py)
share this update skeleton (make_update) and the eval metrics
(eval_metrics). An int8 cache's activations are dequantized on the
device by the wrappers make_dequant_step_fn and make_sae_train_multi_step_quant.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    JUMPRELU_BANDWIDTH,
    SAE_VARIANTS,
    TOPK_FAMILY,
    batch_topk_threshold_update,
    matryoshka_prefix_counts,
    sae_inference_and_loss,
    topk_aux_loss,
)
from sparse_vision_tpu_torch.ops import metrics, optim
from sparse_vision_tpu_torch.ops.fast_batch_topk import fast_batch_topk_sae_loss_terms
from sparse_vision_tpu_torch.ops.fast_topk_sae import fast_topk_sae_loss_terms
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


class ModelTrainState(NamedTuple):
    params: dict  # the backbone's, nested by stage
    net_state: dict  # batch-norm running statistics
    opt_state: object  # the model optimizer's (ops/optim.py)
    step: int  # completed train batches


class LocalSync:
    """What a train step reduces across the ranks of a mesh: nothing, on one
    rank (``mesh`` None). parallel/sharded_steps.DataSync (data parallel) and
    parallel/tensor_parallel.ModelSync (tensor parallel) reduce over the
    mesh's axes: the gradients, the batch's dead mask, the step's metrics and
    the dead fraction."""

    mesh = None

    def grads(self, grads: dict) -> dict:
        return grads

    def dead(self, dead: torch.Tensor) -> torch.Tensor:
        return dead

    def metrics(self, m: dict) -> dict:
        return m

    def dead_fraction(self, dead_acc: torch.Tensor) -> torch.Tensor:
        return dead_acc.sum() / dead_acc.shape[0]


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
                                  fused_opts: Optional[dict] = None, topk: int = 32,
                                  topk_approx: bool = False,
                                  jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                                  matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                                  aux_k: int = 0, aux_alpha: float = 0.03125, sync=None):
    """SAE train step over pre-extracted activations [T, C] (the activation-cache
    training mode) for every token variant (not sae_conv, which reads maps).

    ``fused=True`` routes forward, loss and statistics through the variant's
    fused op (``fused_op``): the CUDA kernels on a CUDA tensor, their plain
    versions on a CPU tensor. For the TopK family it routes through the fast
    paths, which are plain torch ops on every device and take any shape:
    topk_sae's gather decode (ops/fast_topk_sae.py) and batch_topk_sae's
    statistics from its selected entries (ops/fast_batch_topk.py).
    ``fused_opts`` may set ``compute_dtype``, and ``bandwidth`` for jumprelu_sae
    (the stock path reads ``jumprelu_bandwidth``). ``matryoshka_prefixes`` are
    matryoshka_sae's prefix fractions, on both paths; ``topk`` is the TopK
    family's k (batch_topk's per-token budget), ``topk_approx`` selects exactly
    as models/sae.topk_sae_apply says. ``aux_k > 0`` adds the TopK family's
    AuxK loss (make_update) and its ``sae_aux_loss`` metric.

    The returned ``step_fn(ts, act, resample_draws=None) -> (ts, metrics)``
    (make_train_step) resamples (sae_mlp only) with Kaiming draws from ``ts.rng``
    unless ``resample_draws`` = (enc [h, d], dec [d, h]) is given (tests inject
    the JAX package's draws). The variants that do not resample use the rolling
    dead window instead. batch_topk's threshold follows its EMA.

    ``sync`` (LocalSync by default) is make_update's; the data-parallel step
    (parallel/sharded_steps.make_sharded_fused_train_step) passes its
    DataSync: ``act`` is then the rank's token shard, the state is replicated,
    and batch_topk selects against the global batch's cutoff on every path
    (``sync.mesh``), as the JAX package's sharded step does."""
    if sae_model_name not in SAE_VARIANTS:
        raise ValueError(f"Unknown SAE model name {sae_model_name}.")
    if sae_model_name == "sae_conv":
        raise ValueError("sae_conv reads feature maps, not cached tokens: train it with "
                         "make_sae_train_step")
    sync = LocalSync() if sync is None else sync
    mesh = sync.mesh
    if fused and sae_model_name == "topk_sae":
        def loss_fn(params, act):
            return fast_topk_sae_loss_terms(params, act, lambda_sparse, expansion_factor,
                                            topk, approx=topk_approx)
    elif sae_model_name == "batch_topk_sae" and (fused or mesh is not None):
        def loss_fn(params, act):
            return fast_batch_topk_sae_loss_terms(params, act, lambda_sparse,
                                                  expansion_factor, topk, mesh=mesh)
    elif fused:
        _, fused_loss_terms = fused_op(sae_model_name, matryoshka_prefixes)

        def loss_fn(params, act):
            return fused_loss_terms(params, act, lambda_sparse, expansion_factor,
                                    **(fused_opts or {}))
    else:
        def loss_fn(params, act):
            return sae_inference_and_loss(sae_model_name, params, act, lambda_sparse,
                                          topk=topk, topk_approx=topk_approx,
                                          jumprelu_bandwidth=jumprelu_bandwidth,
                                          matryoshka_prefixes=matryoshka_prefixes)

    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, fused,
                           sync=sync,
                           **_variant_hooks(sae_model_name, aux_k, aux_alpha, topk_approx))


def _variant_hooks(sae_model_name: str, aux_k: int, aux_alpha: float,
                   topk_approx: bool) -> dict:
    """make_train_step's per-variant arguments: sae_mlp's resample, the TopK
    family's AuxK term, batch_topk's threshold EMA."""
    hooks = {"resample": resample_sae if sae_model_name == "sae_mlp" else None}
    if aux_k > 0 and sae_model_name in TOPK_FAMILY:
        hooks["aux"] = functools.partial(_aux_term, k_aux=aux_k, approx=topk_approx)
        hooks["aux_alpha"] = aux_alpha
    if sae_model_name == "batch_topk_sae":
        hooks["finish"] = _threshold_ema
    return hooks


def _aux_term(params, act, out, dead_acc, k_aux, approx):
    return topk_aux_loss(params, act, act - out["decoded"], dead_acc, k_aux, approx=approx)


def _threshold_ema(old_params: dict, new_params: dict, out: dict) -> dict:
    """batch_topk's inference threshold is estimated, not trained: the EMA of
    the batches' minimum positive selected value overwrites whatever the
    optimizer left (a zero gradient gives a zero Adam step)."""
    return {**new_params, "threshold": batch_topk_threshold_update(
        old_params["threshold"], out["batch_topk_min_pos"])}


def resample_sae(params: dict, opt_state: dict, dead: torch.Tensor, rng: torch.Generator,
                 draws=None):
    """resample_dead_neurons with Kaiming draws from ``rng`` unless ``draws`` =
    (enc [h, d], dec [d_out, h]) is given; d_out is W_dec's width, so the
    transcoder's rectangular decoder takes the same surgery."""
    if draws is None:
        d, h = params["W_enc"].shape
        draws = kaiming_draws(rng, d, h, params["W_dec"].shape[1])
    return resample_dead_neurons(params, opt_state, dead, *draws)


def make_update(loss_fn, tx: optim.Optimizer, dead_neurons_steps: int,
                expansion_factor: int, fused: bool, resample=None, aux=None,
                aux_alpha: float = 0.0, finish=None, sync=None):
    """The update skeleton shared by the SAE, transcoder and crosscoder steps:
    ``update(ts, *acts, resample_draws=None) -> (ts, metrics, out, loss)``
    takes the gradient of ``loss_fn(params, *acts)["loss"]``, applies the
    optimizer and updates the dead-latent accumulator (from the fused op's
    ``dead`` when ``fused``, else from ``encoded``). ``resample(params,
    opt_state, dead_acc, rng, draws)`` runs on the schedule of
    ops/resample.should_resample, with measurement resets between; with
    ``resample=None`` the accumulator is the rolling window instead, restarting
    all-True every ``dead_neurons_steps`` steps.

    ``aux(params, act, out, dead_acc)`` is the TopK family's AuxK term: reported
    as ``out["aux_loss"]`` every step and added to the loss as ``aux_alpha *
    aux`` only in the mature half of each dead window (step % window >=
    window // 2), so a freshly restarted all-True accumulator never drives it;
    in the other half it runs without a gradient, which leaves the loss and
    the update what the JAX step's zero weight gives. ``finish(old_params,
    new_params, out)`` edits the updated parameters (batch_topk's threshold).

    Parameters that the loss does not read (batch_topk's threshold in
    training) get a zero gradient. Reproduced quirk: ``perc_dead`` is read
    AFTER the reset/resample branch, so at a measurement boundary it reports
    the freshly reset all-True accumulator (100% dead), exactly as the JAX
    step does (ROADMAP queue C).

    The step's parts run in profiler ranges (``torch.profiler.record_function``,
    a no-op without a profiler): "sae_step.loss" (the forward and the loss
    terms), "sae_step.backward", "sae_step.optimizer" and "sae_step.dead_units"
    (the accumulator, resample and metrics), which a trace's device time is
    split by.

    ``sync`` (LocalSync by default) reduces across the ranks of a mesh: the
    gradients before the optimizer, the batch's dead mask before the
    accumulator, the metrics, and the dead fraction behind ``perc_dead``."""
    sync = LocalSync() if sync is None else sync

    def update(ts: SAETrainState, *acts, resample_draws=None):
        keys = list(ts.params)
        params = {k: v.detach().requires_grad_(True) for k, v in ts.params.items()}
        with record_function("sae_step.loss"):
            out = loss_fn(params, *acts)
            loss = out["loss"]
            if aux is not None:
                if ts.step % dead_neurons_steps >= dead_neurons_steps // 2:
                    out["aux_loss"] = aux(params, acts[0], out, ts.dead_acc)
                    loss = loss + aux_alpha * out["aux_loss"]
                else:
                    with torch.no_grad():
                        out["aux_loss"] = aux(params, acts[0], out, ts.dead_acc)
        with record_function("sae_step.backward"):
            grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        with torch.no_grad(), record_function("sae_step.optimizer"):
            grads = sync.grads({k: torch.zeros_like(params[k]) if g is None else g
                                for k, g in zip(keys, grads)})
            updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
            new_params = optim.apply_updates(ts.params, updates)
            if finish is not None:
                new_params = finish(ts.params, new_params, out)
        with torch.no_grad(), record_function("sae_step.dead_units"):
            step = ts.step + 1
            if fused:
                dead, sparsity = out["dead"], out["sparsity"]
            else:
                dead, sparsity, _ = metrics.measure_inactive_units(
                    out["encoded"], expansion_factor)
            dead_acc = ts.dead_acc & sync.dead(dead)
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
            }
            if aux is not None:
                m["sae_aux_loss"] = out["aux_loss"].detach()
            m = {**sync.metrics(m), "perc_dead": sync.dead_fraction(dead_acc)}
        return SAETrainState(new_params, opt_state, step, dead_acc, ts.rng), m, out, loss

    return update


def make_train_step(loss_fn, tx: optim.Optimizer, dead_neurons_steps: int,
                    expansion_factor: int, fused: bool, **hooks):
    """``step_fn(ts, *acts, resample_draws=None) -> (ts, metrics)``: one
    make_update step (``hooks``: its resample, aux, aux_alpha, finish)."""
    update = make_update(loss_fn, tx, dead_neurons_steps, expansion_factor, fused, **hooks)

    def step_fn(ts: SAETrainState, *acts, resample_draws=None):
        return update(ts, *acts, resample_draws=resample_draws)[:2]

    return step_fn


def make_sae_train_step(net, sae_layer: str, sae_model_name: str, lambda_sparse: float,
                        tx: optim.Optimizer, dead_neurons_steps: int, expansion_factor: int,
                        criterion, full_metrics: bool = True, last_stage: Optional[str] = None,
                        topk: int = 32, topk_approx: bool = False,
                        jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                        matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                        aux_k: int = 0, aux_alpha: float = 0.03125):
    """The SAE train step without a cache, the JAX package's default mode:
    ``step_fn(ts, frozen_params, frozen_state, images, labels,
    resample_draws=None) -> (ts, metrics)`` runs the frozen backbone (to
    ``sae_layer`` only when not ``full_metrics``), takes the tap, updates the
    SAE (make_update, with the variant's resample, AuxK and threshold EMA) and,
    with ``full_metrics``, splices the reconstruction back for ``model_loss``,
    ``loss_diff``, ``kld``, ``perc_same``, ``accuracy`` and ``var_expl``.

    Every variant, sae_conv included (on the map itself), runs the stock SAE
    math of models/sae.py on both devices, as the JAX step does: no fused op
    and no fast path, so no kernel launches. The metrics are those of the JAX
    step: the loss terms with ``sae_aux_loss`` (the variant's aux term, or
    AuxK's), ``sparsity`` and ``perc_dead``."""
    last = last_stage or net.stage_names[-1]

    def loss_fn(params, act):
        return sae_inference_and_loss(sae_model_name, params, act, lambda_sparse, topk=topk,
                                      topk_approx=topk_approx,
                                      jumprelu_bandwidth=jumprelu_bandwidth,
                                      matryoshka_prefixes=matryoshka_prefixes)

    update = make_update(loss_fn, tx, dead_neurons_steps, expansion_factor, False,
                         **_variant_hooks(sae_model_name, aux_k, aux_alpha, topk_approx))

    def step_fn(ts: SAETrainState, frozen_params, frozen_state, images, labels,
                resample_draws=None):
        with torch.no_grad():
            logits_orig, taps, _ = net.apply(frozen_params, images, state=frozen_state,
                                             stop_at=None if full_metrics else sae_layer)
        act = taps[sae_layer]
        ts, m, out, _ = update(ts, act, resample_draws=resample_draws)
        with torch.no_grad():
            m = {"sae_loss": m["sae_loss"], "sae_rec_loss": m["sae_rec_loss"],
                 "sae_l1_loss": m["sae_l1_loss"],
                 "sae_nrmse_loss": out["nrmse_loss"].detach(),
                 "sae_rmse_loss": out["rmse_loss"].detach(),
                 "sae_aux_loss": out["aux_loss"].detach(),
                 "sparsity": m["sparsity"], "perc_dead": m["perc_dead"]}
            if full_metrics:
                decoded = out["decoded"].detach()
                logits_mod = net.apply_segment(frozen_params, decoded, after=sae_layer,
                                               upto=last, state=frozen_state)
                loss_mod = criterion(logits_mod, labels)
                m.update(model_loss=loss_mod, loss_diff=loss_mod - criterion(logits_orig, labels),
                         kld=metrics.kld_original_vs_modified(logits_orig, logits_mod),
                         perc_same=metrics.perc_same_classification(logits_orig, logits_mod),
                         accuracy=metrics.accuracy(logits_mod, labels),
                         var_expl=metrics.variance_explained(act, decoded))
        return ts, m

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
                       expansion_factor: int, criterion, topk: int = 32,
                       topk_approx: bool = False,
                       jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                       matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                       input_scale: Optional[float] = None):
    """Eval step for the SAE-spliced model: the reference's eval-epoch quantities
    for one batch (model_pipeline.py:661-714 + 806-878), in plain torch (the JAX
    eval is stock XLA too). Returns (batch_metrics, arrays) with arrays as
    eval_metrics gives them. The SAE runs its deployment form
    (``training=False``: batch_topk gates at its scalar threshold).

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
                                     topk=topk, topk_approx=topk_approx,
                                     jumprelu_bandwidth=jumprelu_bandwidth,
                                     matryoshka_prefixes=matryoshka_prefixes, training=False)
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
    ``var_expl`` is that of the spliced activation ``act`` by ``decoded``.
    ``arrays`` holds 'dead' and 'freq' [U], 'correct', and 'topk_acts' [B, U]:
    the channel-averaged pre-activation (the code itself for gated_sae, which
    has none), which the eval's top-k states rank."""
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
    pre = out["encoded_pre"]
    arrays = {
        "dead": dead,
        "freq": freq,
        "topk_acts": metrics.spatial_mean(out["encoded"] if pre is None else pre),
        "correct": (logits_mod.argmax(1) == labels).sum(),
    }
    return batch_metrics, arrays


def make_model_train_step(net, tx: optim.Optimizer, criterion):
    """The original model's train step (the reference's original_model=True,
    training=True; model_pipeline.py:653-660): ``step_fn(ts, images, labels) ->
    (ts, {"model_loss", "accuracy"})``. The criterion on ``net.apply(...,
    train=True)`` (batch norm on the batch's statistics), its gradient over the
    nested parameters by autograd, the optimizer's update, and the new
    running statistics."""

    def step_fn(ts: ModelTrainState, images: torch.Tensor, labels: torch.Tensor):
        params = optim.tree_map(lambda p: p.detach().requires_grad_(), ts.params)
        leaves: list = []
        optim.tree_map(leaves.append, params)
        logits, _, new_state = net.apply(params, images, state=ts.net_state, train=True)
        loss = criterion(logits, labels)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = optim.tree_map(lambda _: next(flat), params)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
            new_params = optim.apply_updates(ts.params, updates)
            m = {"model_loss": loss.detach(), "accuracy": metrics.accuracy(logits, labels)}
        new_state = optim.tree_map(torch.Tensor.detach, new_state)
        return ModelTrainState(new_params, new_state, opt_state, ts.step + 1), m

    return step_fn


def make_model_eval_step(net, criterion, topk_layer: Optional[str] = None):
    """The original model's eval step: ``step_fn(params, net_state, images,
    labels) -> (metrics, arrays, taps)``, the metrics ``model_loss`` and
    ``accuracy``, ``arrays`` the batch's count of ``correct`` predictions.
    ``topk_layer`` names the backbone layer whose channels the original-model
    top-k and MIS collect (the reference reuses sae_layer for it,
    specify_parameters.py:245-247): ``arrays`` then also holds its channel
    means ``topk_acts`` [B, C] and its ``freq`` and ``dead`` [C] (expansion
    factor 1), and the taps are dropped (an empty dict), as the JAX step drops
    them."""

    @torch.no_grad()
    def step_fn(params: dict, net_state: dict, images: torch.Tensor, labels: torch.Tensor):
        logits, taps, _ = net.apply(params, images, state=net_state)
        m = {"model_loss": criterion(logits, labels),
             "accuracy": metrics.accuracy(logits, labels)}
        arrays = {"correct": (logits.argmax(1) == labels).sum()}
        if topk_layer is None:
            return m, arrays, taps
        act = taps[topk_layer]
        dead, _, freq = metrics.measure_inactive_units(act, 1)
        arrays.update(topk_acts=metrics.spatial_mean(act), freq=freq, dead=dead)
        return m, arrays, {}

    return step_fn
