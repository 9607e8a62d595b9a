"""Crosscoder training: one shared sparse code over L layers' activations (port of
sparse_vision_tpu/train/crosscoder.py; the math and the decoder-norm diffing
readout are in models/crosscoder.py).

All L layers' caches come from one backbone pass (train/paired_caches.py), so
training zips L aligned cache readers. On a mesh of torch.distributed ranks it
trains as the transcoder does (train/transcoder.mesh_step): data parallel on
``(d,)``, and on ``(d, m)`` the fused TP op on a rank's latent shard with the
latent-sharded multi-layer resample (make_tp_crosscoder_train_step); rank 0
writes the decoder-norm CSV from the gathered parameters.
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Optional

import numpy as np
import torch

from sparse_vision_tpu_torch.models.crosscoder import (
    crosscoder_decoder_norms,
    crosscoder_inference_and_loss,
)
from sparse_vision_tpu_torch.ops import optim
from sparse_vision_tpu_torch.ops.resample import (
    crosscoder_kaiming_draws,
    resample_dead_neurons_crosscoder,
    resample_dead_neurons_crosscoder_tp,
)
from sparse_vision_tpu_torch.parallel.tensor_parallel import ModelSync
from sparse_vision_tpu_torch.train.steps import (
    eval_metrics,
    make_sae_train_multi_step,
    make_train_step,
)
from sparse_vision_tpu_torch.train.transcoder import mesh_step, shard_stacks
from sparse_vision_tpu_torch.utils.paths import sae_run_name


def _draws(params: dict, rng, h: int) -> list:
    """crosscoder_kaiming_draws at ``h`` latents for the layers of ``params``."""
    n = sum(1 for k in params if k.startswith("W_enc_"))
    return crosscoder_kaiming_draws(rng, tuple(params[f"W_enc_{i}"].shape[0]
                                               for i in range(n)), h)


def _resample(params, opt_state, dead, rng, draws=None):
    if draws is None:
        draws = _draws(params, rng, dead.shape[0])
    return resample_dead_neurons_crosscoder(params, opt_state, dead, draws)


def resample_crosscoder_tp(params, opt_state, dead, rng, draws=None, *, mesh):
    """resample_dead_neurons_crosscoder_tp with the full global draws from
    ``rng`` (seeded alike on every rank) unless ``draws`` is given (tests hand
    in the JAX package's)."""
    if draws is None:
        draws = _draws(params, rng, dead.shape[0] * mesh.size("model"))
    return resample_dead_neurons_crosscoder_tp(params, opt_state, dead, draws, mesh)


def make_crosscoder_train_step_from_acts(lambda_sparse: float, tx: optim.Optimizer,
                                         dead_neurons_steps: int, expansion_factor: int,
                                         fused: bool = False,
                                         fused_opts: Optional[dict] = None, sync=None):
    """Crosscoder step over aligned cached token batches:
    ``step_fn(ts, xs tuple of [T, d_l], resample_draws=None) -> (ts, metrics)``.
    The SAE step's skeleton (train/steps.make_train_step) with the multi-layer
    resample (ops/resample.resample_dead_neurons_crosscoder; ``resample_draws``
    as crosscoder_kaiming_draws gives them). ``fused=True`` goes through
    ops/fused_crosscoder.py; ``fused_opts`` may set ``compute_dtype``.
    ``sync`` is make_update's (DataSync for the data-parallel step)."""
    if fused:
        from sparse_vision_tpu_torch.ops.fused_crosscoder import fused_crosscoder_loss_terms

        def loss_fn(params, xs):
            return fused_crosscoder_loss_terms(params, xs, lambda_sparse, expansion_factor,
                                               **(fused_opts or {}))
    else:
        def loss_fn(params, xs):
            return crosscoder_inference_and_loss(params, xs, lambda_sparse)

    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, fused,
                           resample=_resample, sync=sync)


def make_tp_crosscoder_train_step(mesh, lambda_sparse: float, tx: optim.Optimizer,
                                  dead_neurons_steps: int, expansion_factor: int,
                                  fused_opts: Optional[dict] = None):
    """The tensor-parallel crosscoder step ``step(ts, xs_local, resample_draws=None)
    -> (ts, metrics)`` (port of the JAX package's make_tp_crosscoder_train_step):
    ``ts`` the rank's shard (put_tp_state: every W_enc_i and W_dec_i on its
    latent axis, each b_dec_i replicated), ``xs_local`` its token rows of
    every layer; the fused TP op (ops/fused_crosscoder.fused_crosscoder_tp_loss_terms),
    whose gradients and metrics come out global, and resample_crosscoder_tp.
    ``fused_opts`` may set ``compute_dtype``."""
    from sparse_vision_tpu_torch.ops.fused_crosscoder import fused_crosscoder_tp_loss_terms

    opts = dict(fused_opts or {})

    def loss_fn(params, xs):
        return fused_crosscoder_tp_loss_terms(params, xs, lambda_sparse, expansion_factor,
                                              mesh, **opts)

    return make_train_step(loss_fn, tx, dead_neurons_steps, expansion_factor, True,
                           resample=functools.partial(resample_crosscoder_tp, mesh=mesh),
                           sync=ModelSync(mesh))


def make_crosscoder_multi_step(step_fn):
    """``multi(ts, stacks)``: K steps over a tuple of [K, T, d_l] stacks, metrics
    stacked [K]."""
    multi = make_sae_train_multi_step(lambda ts, *xs: step_fn(ts, xs))

    def run(ts, stacks: tuple):
        return multi(ts, *stacks)

    return run


def make_crosscoder_eval_step(net, layers: tuple, lambda_sparse: float,
                              expansion_factor: int, criterion,
                              input_scales: Optional[tuple] = None):
    """Eval step for the crosscoder-spliced model, shaped like
    train/steps.make_sae_eval_step's. The code is computed from the original
    activations of all layers, and the deepest layer's activation is replaced by
    its reconstruction: logits_mod = apply_segment(after=layers[-1]) of
    decoded[-1]. ``layers`` are in network depth order; ``var_expl`` is that of
    the deepest layer. ``input_scales`` (sae_input_norm="rms"): each layer's
    token RMS in ``layers`` order; the crosscoder reads every activation divided
    by its layer's, and the splice rescales the deepest reconstruction back."""
    last = net.stage_names[-1]
    invs = None if input_scales is None else tuple(float(1.0 / s) for s in input_scales)

    @torch.no_grad()
    def step_fn(params, frozen_params, frozen_state, images, labels):
        logits_orig, taps, _ = net.apply(frozen_params, images, state=frozen_state)
        acts = tuple(taps[l] for l in layers)
        if invs is not None:
            acts = tuple(a * inv for a, inv in zip(acts, invs))
        out = crosscoder_inference_and_loss(params, acts, lambda_sparse)
        deep = (out["decoded"][-1] if invs is None
                else out["decoded"][-1] * float(input_scales[-1]))
        logits_mod = net.apply_segment(frozen_params, deep, after=layers[-1],
                                       upto=last, state=frozen_state)
        return eval_metrics(out, acts[-1], out["decoded"][-1], logits_orig, logits_mod,
                            labels, criterion, expansion_factor)

    return step_fn


def save_decoder_norms(params: dict, layers: tuple, folder: str, name: str) -> str:
    """Write the model-diffing readout ``<name>_decoder_norms.csv``: one row per
    latent, columns ``unit``, ``norm_<layer>`` for each layer, then
    ``share_<layer>`` (the layer's fraction of the latent's summed norm). The
    JAX package's columns and values, written with the csv module."""
    norms = crosscoder_decoder_norms(params).detach().float().cpu().numpy()  # [L, h]
    shares = norms / np.maximum(norms.sum(axis=0), np.float32(1e-12))
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{name}_decoder_norms.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["unit"] + [f"norm_{l}" for l in layers] + [f"share_{l}" for l in layers])
        for j in range(norms.shape[1]):  # float32 values, each in its shortest form
            w.writerow([j, *map(str, norms[:, j]), *map(str, shares[:, j])])
    return path


def train_crosscoder_cached(pipe) -> dict:
    """Cached crosscoder training through a Pipeline: dump all L layers' caches in
    one backbone pass (overlapped with the first epoch run under
    overlap_dump_train), train on zipped token stacks (each layer on its ``/
    rms`` basis under sae_input_norm="rms", which crosscoders over layers of
    unlike scales need) from ``sae_checkpoint_epoch`` on, with the Pipeline's
    evals, checkpoints and export (Pipeline.run_epochs), then write the
    decoder-norm diffing CSV into the run's sae_weights folder. Returns the
    last eval's means."""
    from sparse_vision_tpu_torch.ops.fused_crosscoder import can_fuse
    from sparse_vision_tpu_torch.train.paired_caches import epoch_stacks, prepare_caches

    cfg = pipe.cfg
    if cfg.sae_optimizer_name == "constrained_adam":
        raise ValueError(
            "crosscoders need a plain optimizer (sae_optimizer_name='adam'): "
            "ConstrainedAdam's unit-norm decoder invariant erases the per-layer "
            "decoder-norm signal the variant exists to measure (models/crosscoder.py)")
    c_cat = sum(pipe.crosscoder_dims)  # the kernels run in the concatenated space
    args = (cfg.sae_lambda_sparse, pipe.tx, cfg.dead_neurons_steps, cfg.sae_expansion_factor)
    opts = {"compute_dtype": cfg.compute_dtype}
    step_fn = mesh_step(
        pipe, can_fuse, c_cat, c_cat,
        lambda fused, sync: make_crosscoder_train_step_from_acts(
            *args, fused=fused, fused_opts=opts, sync=sync),
        lambda: make_tp_crosscoder_train_step(pipe.mesh, *args, fused_opts=opts))
    layers = pipe.crosscoder_all_layers
    dirs = {l: pipe._cache_dir(l) for l in layers}
    stream_qs, dump_thread, caches = prepare_caches(pipe, layers, dirs)
    opened = [caches]

    def epoch_items(epoch):
        it, opened[0] = epoch_stacks(pipe, layers, dirs, epoch, cfg.sae_checkpoint_epoch,
                                     stream_qs, dump_thread, opened[0])
        return ((stacks, None) for stacks in shard_stacks(pipe.mesh, it))

    last_eval = pipe.run_epochs(
        pipe.normalized_step(lambda ts, *xs: step_fn(ts, xs), layers), epoch_items)
    if dump_thread is not None:
        dump_thread.join()
    if pipe.is_main:  # on a mesh every rank leaves run_epochs with the whole state
        path = save_decoder_norms(pipe.ts.params, layers, pipe.paths["sae_weights"],
                                  sae_run_name(cfg))
        print(f"Saved crosscoder decoder-norm diffing CSV to {path}")
        pipe.decoder_norms_path = path
    return last_eval
