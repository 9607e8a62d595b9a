"""Transcoder training: a sparse dictionary that maps one layer's activations to
another layer's (port of sparse_vision_tpu/train/transcoder.py; Dunefsky et al.
2024).

z = ReLU(x_in W_enc + b_enc), y_hat = z W_dec + b_dec is trained against the
target layer's activations; the spliced model then runs backbone -> in_layer ->
transcoder -> the stages after the target layer. Both layers' caches come from
one backbone pass (train/paired_caches.py), so training zips them.

On a mesh of torch.distributed ranks (Pipeline's ``mesh``) it trains data
parallel on ``(d,)`` (the single-device step, its gradients all-reduced:
parallel/sharded_steps.DataSync) and tensor parallel on ``(d, m)``
(make_tp_transcoder_train_step: the fused TP op on a rank's latent shard,
whatever ``use_pallas`` says, as the JAX package). Every rank takes its token
rows of both paired stacks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from sparse_vision_tpu_torch.models.sae import transcoder_inference_and_loss
from sparse_vision_tpu_torch.ops import optim
from sparse_vision_tpu_torch.parallel import tensor_parallel
from sparse_vision_tpu_torch.parallel.distributed import process_local_batch_slice
from sparse_vision_tpu_torch.parallel.sharded_steps import (
    DataSync,
    put_replicated_state,
    put_tokens_sharded,
)
from sparse_vision_tpu_torch.train.steps import (
    eval_metrics,
    make_sae_train_multi_step,
    make_train_step,
    resample_sae,
)


def make_transcoder_train_step_from_acts(lambda_sparse: float, tx: optim.Optimizer,
                                         dead_neurons_steps: int, expansion_factor: int,
                                         fused: bool = False,
                                         fused_opts: Optional[dict] = None, sync=None):
    """Transcoder step over paired cached activations:
    ``step_fn(ts, x_in [T, d_in], y_tgt [T, d_out], resample_draws=None) -> (ts,
    metrics)``. The SAE step's skeleton (train/steps.make_train_step), with
    sae_mlp's resample on the rectangular decoder. ``fused=True`` goes through
    ops/fused_transcoder.py: the CUDA kernels on a CUDA tensor, their plain
    versions on a CPU tensor; ``fused_opts`` may set ``compute_dtype``.
    ``sync`` is make_update's (DataSync for the data-parallel step: the
    arguments are then the rank's token rows and the state is replicated)."""
    if fused:
        from sparse_vision_tpu_torch.ops.fused_transcoder import fused_transcoder_loss_terms

        def loss_fn(params, x_in, y_tgt):
            return fused_transcoder_loss_terms(params, x_in, y_tgt, lambda_sparse,
                                               expansion_factor, **(fused_opts or {}))
    else:
        def loss_fn(params, x_in, y_tgt):
            return transcoder_inference_and_loss(params, x_in, y_tgt, lambda_sparse)

    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, fused,
                           resample=resample_sae, sync=sync)


def make_tp_transcoder_train_step(mesh, lambda_sparse: float, tx: optim.Optimizer,
                                  dead_neurons_steps: int, expansion_factor: int,
                                  fused_opts: Optional[dict] = None):
    """The tensor-parallel transcoder step ``step(ts, x_local, y_local,
    resample_draws=None) -> (ts, metrics)`` (port of the JAX package's
    make_tp_transcoder_train_step): ``ts`` the rank's shard (put_tp_state),
    ``x_local`` / ``y_local`` its token rows of both layers; the fused TP op
    (ops/fused_transcoder.fused_transcoder_tp_loss_terms), whose gradients
    and metrics come out global, and the latent-sharded resample
    (parallel/tensor_parallel.resample_sae_tp, whose surgery takes the
    rectangular decoder). ``fused_opts`` may set ``compute_dtype``."""
    from sparse_vision_tpu_torch.ops.fused_transcoder import fused_transcoder_tp_loss_terms

    opts = dict(fused_opts or {})

    def loss_fn(params, x_in, y_tgt):
        return fused_transcoder_tp_loss_terms(params, x_in, y_tgt, lambda_sparse,
                                              expansion_factor, mesh, **opts)

    resample = functools.partial(tensor_parallel.resample_sae_tp, mesh=mesh)
    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, True,
                           resample=resample, sync=tensor_parallel.ModelSync(mesh))


def mesh_step(pipe, can_fuse, c_in: int, c_out: int, make_single, make_tp):
    """The step of a paired-cache trainer (the transcoder, the crosscoder) on
    ``pipe``'s mesh, with ``pipe.ts`` placed for it: on one rank
    ``make_single(fused, None)``; on ``(d,)`` ``make_single(fused, sync)``
    with the 'data' axis's DataSync, the state replicated; on ``(d, m)``
    ``make_tp()``, the state on the latent shards (put_tp_state). Before any
    dump: the mesh mode is validated, and the kernels' shape rule
    (``can_fuse`` at a rank's T/d tokens and H/m latents) is checked on the
    card, under a 'model' axis whatever use_pallas says (the TP op always
    runs)."""
    from sparse_vision_tpu_torch.train.pipeline import validate_mesh_mode

    mesh = pipe.mesh
    cfg = pipe.cfg
    n_data, n_model = (1, 1) if mesh is None else (mesh.size("data"), mesh.size("model"))
    if mesh is not None:
        validate_mesh_mode(dataclasses.replace(cfg, mesh_shape=mesh.shape), pipe.num_units)
    t_local = process_local_batch_slice(cfg.cache_tokens_per_step, n_data)
    fused = pipe.check_fusable(can_fuse, c_in, c_out, t=t_local, h=pipe.num_units // n_model,
                               always=n_model > 1)
    if n_model > 1:
        pipe.ts = tensor_parallel.put_tp_state(mesh, pipe.ts)
        return make_tp()
    if mesh is not None:
        pipe.ts = put_replicated_state(mesh, pipe.ts)
    return make_single(fused, None if mesh is None else DataSync(mesh))


def shard_stacks(mesh, items):
    """Each item's stacks, a tuple of [k, T, C_l], cut to this rank's token
    rows on a mesh (every rank of a data index takes the same rows)."""
    if mesh is None:
        return items
    return (tuple(put_tokens_sharded(mesh, s, 1) for s in stacks) for stacks in items)


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
    args = (cfg.sae_lambda_sparse, pipe.tx, cfg.dead_neurons_steps, cfg.sae_expansion_factor)
    opts = {"compute_dtype": cfg.compute_dtype}
    step_fn = mesh_step(
        pipe, can_fuse, pipe.sae_input_size, pipe.transcoder_out_size,
        lambda fused, sync: make_transcoder_train_step_from_acts(
            *args, fused=fused, fused_opts=opts, sync=sync),
        lambda: make_tp_transcoder_train_step(pipe.mesh, *args, fused_opts=opts))
    layers = (cfg.sae_layer, tgt)
    dirs = {l: pipe._cache_dir(l) for l in layers}
    stream_qs, dump_thread, caches = prepare_caches(pipe, layers, dirs)
    opened = [caches]

    def epoch_items(epoch):
        it, opened[0] = epoch_stacks(pipe, layers, dirs, epoch, cfg.sae_checkpoint_epoch,
                                     stream_qs, dump_thread, opened[0])
        return ((stacks, None) for stacks in shard_stacks(pipe.mesh, it))

    last_eval = pipe.run_epochs(pipe.normalized_step(step_fn, layers), epoch_items)
    if dump_thread is not None:
        dump_thread.join()
    return last_eval
