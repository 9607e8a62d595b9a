"""Transcoder training: a sparse dictionary that maps one layer's activations to
another layer's (port of the single-device parts of
sparse_vision_tpu/train/transcoder.py; Dunefsky et al. 2024).

z = ReLU(x_in W_enc + b_enc), y_hat = z W_dec + b_dec is trained against the
target layer's activations; the spliced model then runs backbone -> in_layer ->
transcoder -> the stages after the target layer. Both layers' caches come from
one backbone pass (train/paired_caches.py), so training zips them.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_vision_tpu_torch.models.sae import transcoder_inference_and_loss
from sparse_vision_tpu_torch.ops import optim
from sparse_vision_tpu_torch.train.steps import (
    eval_metrics,
    make_sae_train_multi_step,
    make_train_step,
    resample_sae,
)


def make_transcoder_train_step_from_acts(lambda_sparse: float, tx: optim.Optimizer,
                                         dead_neurons_steps: int, expansion_factor: int,
                                         fused: bool = False,
                                         fused_opts: Optional[dict] = None):
    """Transcoder step over paired cached activations:
    ``step_fn(ts, x_in [T, d_in], y_tgt [T, d_out], resample_draws=None) -> (ts,
    metrics)``. The SAE step's skeleton (train/steps.make_train_step), with
    sae_mlp's resample on the rectangular decoder. ``fused=True`` goes through
    ops/fused_transcoder.py: the CUDA kernels on a CUDA tensor, their plain
    versions on a CPU tensor; ``fused_opts`` may set ``compute_dtype``."""
    if fused:
        from sparse_vision_tpu_torch.ops.fused_transcoder import fused_transcoder_loss_terms

        def loss_fn(params, x_in, y_tgt):
            return fused_transcoder_loss_terms(params, x_in, y_tgt, lambda_sparse,
                                               expansion_factor, **(fused_opts or {}))
    else:
        def loss_fn(params, x_in, y_tgt):
            return transcoder_inference_and_loss(params, x_in, y_tgt, lambda_sparse)

    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, fused,
                           resample_sae)


def make_transcoder_multi_step(step_fn):
    """``multi(ts, x_stack [K, T, d_in], y_stack [K, T, d_out])``: K steps, metrics
    stacked [K]."""
    return make_sae_train_multi_step(step_fn)


def make_transcoder_eval_step(net, in_layer: str, tgt_layer: str, lambda_sparse: float,
                              expansion_factor: int, criterion,
                              input_scales: Optional[tuple] = None):
    """Eval step for the transcoder-spliced model, shaped like
    train/steps.make_sae_eval_step's. The modified model skips the segment
    (in_layer, tgt_layer]: logits_mod = backbone to in_layer -> transcoder ->
    apply_segment(after=tgt_layer). ``var_expl`` is that of the target layer.
    ``input_scales`` (sae_input_norm="rms"): (rms_in, rms_tgt); the transcoder
    reads ``act_in / rms_in``, predicts on the ``/ rms_tgt`` basis, and the
    splice rescales its prediction back."""
    last = net.stage_names[-1]
    inv_in = inv_tgt = None
    if input_scales is not None:
        inv_in, inv_tgt = (float(1.0 / s) for s in input_scales)

    @torch.no_grad()
    def step_fn(params, frozen_params, frozen_state, images, labels):
        logits_orig, taps, _ = net.apply(frozen_params, images, state=frozen_state)
        act_in, act_tgt = taps[in_layer], taps[tgt_layer]
        if inv_in is not None:
            act_in, act_tgt = act_in * inv_in, act_tgt * inv_tgt
        out = transcoder_inference_and_loss(params, act_in, act_tgt, lambda_sparse)
        decoded = (out["decoded"] if inv_tgt is None
                   else out["decoded"] * float(input_scales[1]))
        logits_mod = net.apply_segment(frozen_params, decoded, after=tgt_layer,
                                       upto=last, state=frozen_state)
        return eval_metrics(out, act_tgt, out["decoded"], logits_orig, logits_mod, labels,
                            criterion, expansion_factor)

    return step_fn


def train_transcoder_cached(pipe) -> dict:
    """Cached transcoder training through a Pipeline: dump both layers' caches in
    one backbone pass (overlapped with the first epoch run under
    overlap_dump_train), train on zipped token stacks (on the ``/ rms`` basis of
    each layer under sae_input_norm="rms") from ``sae_checkpoint_epoch`` on,
    with the Pipeline's evals, checkpoints and export (Pipeline.run_epochs).
    Returns the last eval's means."""
    from sparse_vision_tpu_torch.ops.fused_transcoder import can_fuse
    from sparse_vision_tpu_torch.train.paired_caches import epoch_stacks, prepare_caches

    cfg = pipe.cfg
    tgt = cfg.transcoder_target_layer
    if not tgt:
        raise ValueError("transcoder runs need transcoder_target_layer set")
    fused = pipe.check_fusable(can_fuse, pipe.sae_input_size, pipe.transcoder_out_size)
    layers = (cfg.sae_layer, tgt)
    dirs = {l: pipe._cache_dir(l) for l in layers}
    stream_qs, dump_thread, caches = prepare_caches(pipe, layers, dirs)
    step_fn = make_transcoder_train_step_from_acts(
        cfg.sae_lambda_sparse, pipe.tx, cfg.dead_neurons_steps, cfg.sae_expansion_factor,
        fused=fused, fused_opts={"compute_dtype": cfg.compute_dtype})
    opened = [caches]

    def epoch_items(epoch):
        it, opened[0] = epoch_stacks(pipe, layers, dirs, epoch, cfg.sae_checkpoint_epoch,
                                     stream_qs, dump_thread, opened[0])
        return ((stacks, None) for stacks in it)

    last_eval = pipe.run_epochs(pipe.normalized_step(step_fn, layers), epoch_items)
    if dump_thread is not None:
        dump_thread.join()
    return last_eval
