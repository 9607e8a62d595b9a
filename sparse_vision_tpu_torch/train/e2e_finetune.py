"""End-to-end finetune of a trained dictionary on the downstream KL (port of
sparse_vision_tpu/train/e2e_finetune.py; arXiv:2503.17272, PAPERS.md).

After MSE training, a short pass minimizes KL(modified || original) of the
spliced model's logits (ops/metrics.kld_original_vs_modified, the KLD the
results row reports), plus ``alpha_mse`` x the reconstruction MSE as an
anchor, plus λ x the L1 term. The gradient flows through the spliced
downstream segment into the dictionary's parameters only: the backbone is
frozen and runs in eval mode. The optimizer state continues from training
(ConstrainedAdam's decoder-row renorm included); no resampling runs, and the
dead accumulator keeps ANDing for observability.

The splices follow the eval steps, so the finetune optimizes the KLD the
eval reports:
- SAE: ``sae_layer``'s activation replaced by its reconstruction;
- transcoder: the segment (in_layer, target_layer] skipped: backbone to
  in_layer -> transcoder -> the stages after target_layer;
- crosscoder: acausal, the code from all L original taps and the deepest
  layer's activation replaced by its reconstruction.

Each step runs the stock math of models/sae.py and models/crosscoder.py on
either device, as the JAX step does: no fused op, no kernel launch.
``sae_e2e_finetune_epochs > 0`` runs ``e2e_finetune`` at the end of every
trainer (Pipeline._epochs), before the crosscoder's decoder-norm CSV.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from sparse_vision_tpu_torch.models.crosscoder import crosscoder_inference_and_loss
from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    JUMPRELU_BANDWIDTH,
    batch_topk_threshold_update,
    sae_inference_and_loss,
    transcoder_inference_and_loss,
)
from sparse_vision_tpu_torch.ops import metrics, optim
from sparse_vision_tpu_torch.train.steps import SAETrainState


def _splice_loss(net, after: str, last: Optional[str], alpha_mse: float,
                 lambda_sparse: float, run):
    """``loss_fn(params, frozen_params, frozen_state, images) -> (loss, (out,
    kld, logits_orig, logits_mod))``: the frozen backbone's logits and taps
    without a graph, ``run(params, taps) -> (out, activation spliced in after
    `after`)``, the rest of the backbone on it, and the finetune loss."""
    last = last or net.stage_names[-1]

    def loss_fn(params, frozen_params, frozen_state, images):
        with torch.no_grad():
            logits_orig, taps, _ = net.apply(frozen_params, images, state=frozen_state)
        out, spliced = run(params, taps)
        logits_mod = net.apply_segment(frozen_params, spliced, after=after, upto=last,
                                       state=frozen_state)
        kld = metrics.kld_original_vs_modified(logits_orig, logits_mod)
        loss = kld + alpha_mse * out["rec_loss"] + lambda_sparse * out["l1_loss"]
        return loss, (out, kld, logits_orig, logits_mod)

    return loss_fn


def make_sae_e2e_finetune_step(net, sae_layer: str, sae_model_name: str,
                               lambda_sparse: float, tx: optim.Optimizer,
                               alpha_mse: float = 0.0, last_stage: Optional[str] = None,
                               topk: int = 32, topk_approx: bool = False,
                               jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                               matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES):
    """``step_fn(ts, frozen_params, frozen_state, images, labels) -> (ts,
    metrics)`` minimizing KL(spliced || original) + alpha_mse · rec + λ · L1
    over the SAE's parameters (any variant, its training form)."""

    def run(params, taps):
        out = sae_inference_and_loss(sae_model_name, params, taps[sae_layer], lambda_sparse,
                                     topk=topk, topk_approx=topk_approx,
                                     jumprelu_bandwidth=jumprelu_bandwidth,
                                     matryoshka_prefixes=matryoshka_prefixes)
        return out, out["decoded"]

    return _finetune_step_from_loss(
        _splice_loss(net, sae_layer, last_stage, alpha_mse, lambda_sparse, run), tx)


def make_transcoder_e2e_finetune_step(net, in_layer: str, tgt_layer: str,
                                      lambda_sparse: float, tx: optim.Optimizer,
                                      alpha_mse: float = 0.0,
                                      last_stage: Optional[str] = None):
    """The transcoder's step: the segment-skip splice (backbone -> in_layer ->
    transcoder -> the stages after tgt_layer), + alpha_mse · MSE(y_hat,
    y_tgt) + λ · L1."""

    def run(params, taps):
        out = transcoder_inference_and_loss(params, taps[in_layer], taps[tgt_layer],
                                            lambda_sparse)
        return out, out["decoded"]

    return _finetune_step_from_loss(
        _splice_loss(net, tgt_layer, last_stage, alpha_mse, lambda_sparse, run), tx)


def make_crosscoder_e2e_finetune_step(net, layers: tuple, lambda_sparse: float,
                                      tx: optim.Optimizer, alpha_mse: float = 0.0,
                                      last_stage: Optional[str] = None):
    """The crosscoder's step: the acausal splice (the code from all L taps, the
    deepest replaced by its reconstruction), + alpha_mse · the summed
    per-layer MSE + λ · the decoder-norm-weighted L1. Only the deepest decoder
    gets a KL gradient; the L1 reaches every decoder."""

    def run(params, taps):
        out = crosscoder_inference_and_loss(params, tuple(taps[l] for l in layers),
                                            lambda_sparse)
        return out, out["decoded"][-1]

    return _finetune_step_from_loss(
        _splice_loss(net, layers[-1], last_stage, alpha_mse, lambda_sparse, run), tx)


def _finetune_step_from_loss(loss_fn, tx: optim.Optimizer):
    """The shared step: the gradient of ``loss_fn`` over the dictionary's
    parameters (a zero gradient for those the loss does not read), the
    optimizer's update, batch_topk's threshold EMA, the dead accumulator ANDed
    (no resample, no reset), and the metrics e2e_loss, kld, sae_rec_loss,
    sae_l1_loss, perc_same and sparsity (over the code's latents)."""

    def step_fn(ts: SAETrainState, frozen_params: dict, frozen_state: dict,
                images: torch.Tensor, labels: torch.Tensor):
        keys = list(ts.params)
        params = {k: v.detach().requires_grad_(True) for k, v in ts.params.items()}
        loss, (out, kld, logits_orig, logits_mod) = loss_fn(params, frozen_params,
                                                           frozen_state, images)
        grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(keys, grads)}
            updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
            new_params = optim.apply_updates(ts.params, updates)
            if "batch_topk_min_pos" in out:
                new_params = {**new_params, "threshold": batch_topk_threshold_update(
                    ts.params["threshold"], out["batch_topk_min_pos"])}
            dead, sparsity, _ = metrics.measure_inactive_units(out["encoded"], 1)
            m = {"e2e_loss": loss.detach(), "kld": kld.detach(),
                 "sae_rec_loss": out["rec_loss"].detach(),
                 "sae_l1_loss": out["l1_loss"].detach(),
                 "perc_same": metrics.perc_same_classification(logits_orig, logits_mod),
                 "sparsity": sparsity}
        return SAETrainState(new_params, opt_state, ts.step + 1, ts.dead_acc & dead,
                             ts.rng), m

    return step_fn


def finetune_step_for(pipe):
    """The finetune step of ``pipe``'s dictionary at its config."""
    cfg = pipe.cfg
    if cfg.sae_model_name == "transcoder":
        return make_transcoder_e2e_finetune_step(
            pipe.net, cfg.sae_layer, cfg.transcoder_target_layer, cfg.sae_lambda_sparse,
            pipe.tx, alpha_mse=cfg.sae_e2e_alpha_mse)
    if cfg.sae_model_name == "crosscoder":
        return make_crosscoder_e2e_finetune_step(
            pipe.net, pipe.crosscoder_all_layers, cfg.sae_lambda_sparse, pipe.tx,
            alpha_mse=cfg.sae_e2e_alpha_mse)
    return make_sae_e2e_finetune_step(
        pipe.net, cfg.sae_layer, cfg.sae_model_name, cfg.sae_lambda_sparse, pipe.tx,
        alpha_mse=cfg.sae_e2e_alpha_mse, topk=cfg.sae_topk, topk_approx=cfg.sae_topk_approx,
        jumprelu_bandwidth=cfg.jumprelu_bandwidth,
        matryoshka_prefixes=cfg.matryoshka_prefix_fractions)


def e2e_finetune(pipe, epochs: Optional[int] = None) -> Optional[dict]:
    """The finetune of ``pipe``'s trained dictionary: ``epochs`` (default
    ``cfg.sae_e2e_finetune_epochs``) passes over the train images in
    ``sae_batch_size`` batches, shuffled by ``cfg.seed + 1000 + e``, through
    the backbone (a cached run's cache is not read). After each epoch a
    checkpoint numbered ``sae_epochs + e + 1`` and an eval (``final`` on the
    last); then the weights are exported again. A run resumed from a
    checkpoint past ``sae_epochs`` runs only the epochs left. Keeps each step's
    metrics in ``pipe.finetune_log`` and each epoch's timing in
    ``pipe.finetune_timing``. Returns the last eval's means (None when no
    epoch runs)."""
    from sparse_vision_tpu_torch.train import checkpoint as ckpt

    cfg = pipe.cfg
    epochs = cfg.sae_e2e_finetune_epochs if epochs is None else epochs
    if epochs <= 0:
        return None
    step_fn = finetune_step_for(pipe)
    base = cfg.sae_epochs
    last_eval = None
    for e in range(max(0, cfg.sae_checkpoint_epoch - base), epochs):
        t0, steps0, images = time.perf_counter(), pipe.ts.step, 0
        for b in pipe._batches(pipe.train_ds, cfg.sae_batch_size, shuffle=True,
                               seed=cfg.seed + 1000 + e):
            pipe.ts, m = step_fn(pipe.ts, pipe.frozen_params, pipe.net_state, b.images,
                                 b.labels)
            pipe.logger.log_train(pipe.ts.step, m)
            pipe.finetune_log.append((pipe.ts.step, m))
            images += b.images.shape[0]
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        pipe.finetune_timing.append({"epoch": base + e, "steps": pipe.ts.step - steps0,
                                     "images": images, "seconds": time.perf_counter() - t0})
        ckpt.save_checkpoint(pipe._sae_ckpt_dir(), base + e + 1, pipe._ckpt_tree(),
                             blocking=False)
        last_eval = pipe.eval_modified(epoch=base + e + 1, final=e + 1 == epochs)
    ckpt.wait_for_saves()
    pipe._export_sae_weights()
    return last_eval
