"""Vmapped hyperparameter sweeps (port of sparse_vision_tpu/train/sweep_vmap.py):
N same-shape dictionaries that differ only in SWEEPABLE_FIELDS (λ, learning
rate, seed) train in one step off one activation stream.

The reference sweeps as N cluster jobs over ``parameters.txt`` lines, each
paying the data, backbone and dispatch cost again. Here one step serves all N
combos: the parameters, Adam moments and dead-latent accumulators are stacked
on a leading combo axis, and one shared [T, C] batch feeds every combo.

- The fused step (``fused=True``, the production path on the card) runs the
  variant's fused op on the stacked parameters (ops/fused_sae.py's
  FusedSAEFunction and its gated, JumpReLU and Matryoshka twins, each through
  its sweep entry points when the parameters carry a combo axis): one forward
  and one backward launch of the CUDA bodies for all N combos, the combo as
  the grid's second dimension, as
  pallas_call's vmap batching rule makes the Pallas kernels one launch with the
  combo as the outer grid dimension. The per-combo losses are summed for one
  backward: the combos share no parameter, so each combo's gradient is its own.
- The stock step, and the transcoder and crosscoder sweeps (stock XLA in the
  JAX package too), run ``torch.func.vmap`` over ``torch.func.grad_and_value``
  of the model's loss on the stacked parameters.
- topk_sae under ``fused=True``: JAX calls its TopK fast path there, which is
  XLA and no kernel; the port's fast path (ops/fast_topk_sae.GatherDecode) has
  no vmap rule, so the sweep runs the stock TopK math under vmap (ROADMAP A's
  design decisions).

Per combo the update is the single-device step's (train/steps.make_update):
the loss, the optimizer with that combo's learning rate (ops/optim.py takes an
[N] tensor), the dead-latent accumulator, then sae_mlp's scheduled resample /
measurement reset or the other variants' rolling dead window. The resample
stays outside the batched step, as JAX keeps its ``lax.cond`` outside the vmap:
at a resample step each combo runs resample_sae with its own generator. All
combos share one step counter and schedule.

The cached trainers (train_sae_sweep_cached and its transcoder and crosscoder
twins) build one Pipeline per combo for its artifacts (checkpoints, evals,
results rows, exports) and share the first combo's backbone and cache; data
order follows ``base_cfg.seed``, and a combo's ``seed`` moves only its
dictionary's init and resample draws. The sweep runs on one rank: on a mesh
it raises (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import NamedTuple, Optional, Sequence

import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    JUMPRELU_BANDWIDTH,
    sae_inference_and_loss,
    transcoder_inference_and_loss,
)
from sparse_vision_tpu_torch.ops import metrics, optim
from sparse_vision_tpu_torch.ops.resample import should_resample, should_reset_measurement
from sparse_vision_tpu_torch.train.steps import SAETrainState, resample_sae

# the only RunConfig fields a sweep combo may override (everything else is
# shared, so the stacked states are homogeneous)
SWEEPABLE_FIELDS = ("sae_lambda_sparse", "sae_learning_rate", "seed")


class SweepState(NamedTuple):
    """N stacked train states sharing one step counter and schedule."""

    params: dict  # leaves stacked [N, ...]
    opt_state: dict  # Adam's moments stacked [N, ...], one shared count
    step: int  # completed train batches (train_batch_idx)
    dead_acc: torch.Tensor  # bool [N, h]
    rngs: list  # N torch.Generators: each combo's resample draws


def _stack(trees: list):
    """The leaves of same-structure trees stacked on a new leading axis; an int
    leaf (Adam's count) must agree and stays one int."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple):  # sgd's empty state
        return first
    if len(set(trees)) != 1:
        raise ValueError(f"sweep states disagree on {trees}")
    return first


def _slice(tree, i: int):
    """Combo ``i``'s part of a stacked tree (a view of each leaf)."""
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else tree


def stack_sae_states(states: Sequence[SAETrainState]) -> SweepState:
    """Stack per-combo states of one structure and shape along a new leading
    axis. All states must carry the same ``step`` (fresh, or restored from the
    same epoch): the sweep advances one shared counter."""
    steps = {int(s.step) for s in states}
    if len(steps) != 1:
        raise ValueError(f"Sweep states disagree on train step: {sorted(steps)}")
    return SweepState(params=_stack([s.params for s in states]),
                      opt_state=_stack([s.opt_state for s in states]),
                      step=states[0].step, dead_acc=torch.stack([s.dead_acc for s in states]),
                      rngs=[s.rng for s in states])


def unstack_sae_state(ss: SweepState, i: int) -> SAETrainState:
    """Combo ``i``'s state as a plain SAETrainState (checkpoint and eval
    compatible; its tensors are views of the stack)."""
    return SAETrainState(params=_slice(ss.params, i), opt_state=_slice(ss.opt_state, i),
                         step=ss.step, dead_acc=ss.dead_acc[i], rng=ss.rngs[i])


def _hyper(lambdas, learning_rates, device) -> tuple:
    lams = torch.as_tensor(list(lambdas), dtype=torch.float32, device=device)
    lrs = torch.as_tensor(list(learning_rates), dtype=torch.float32, device=device)
    if lams.shape != lrs.shape:
        raise ValueError("lambdas and learning_rates must have equal length")
    return lams, lrs


def _fused_sweep_loss(sae_model_name: str, expansion_factor: int, matryoshka_prefixes,
                      fused_opts: dict):
    """``loss(params, act, lambdas) -> terms`` of the variant's sweep op
    (module docstring), or None for topk_sae (the stock math under vmap)."""
    from sparse_vision_tpu_torch.ops import (
        fused_gated_sae,
        fused_jumprelu_sae,
        fused_matryoshka_sae,
        fused_sae,
    )

    if sae_model_name == "topk_sae":
        return None
    ops = {"sae_mlp": fused_sae.fused_sae_sweep_loss_terms,
           "gated_sae": fused_gated_sae.fused_gated_sweep_loss_terms,
           "jumprelu_sae": fused_jumprelu_sae.fused_jumprelu_sweep_loss_terms,
           "matryoshka_sae": fused_matryoshka_sae.fused_matryoshka_sweep_loss_terms}
    if sae_model_name not in ops:
        raise ValueError(f"fused sweep path does not support {sae_model_name}")
    opts = dict(fused_opts)
    if sae_model_name == "matryoshka_sae":
        opts["prefixes"] = tuple(matryoshka_prefixes)

    def loss(params, act, lams):
        return ops[sae_model_name](params, act, lams, expansion_factor, **opts)

    return loss


def _vmapped_loss(loss_fn, expansion_factor: int):
    """``loss(params, *acts, lambdas) -> terms``: ``loss_fn(params_n, *acts,
    λ_n)`` (the model's loss terms) for every combo under torch.func.vmap, with
    its gradient by torch.func.grad_and_value; ``terms`` holds the gradients
    ("grads"), the [N] loss terms and the dead mask [N, h] and sparsity [N] of
    each combo's code."""

    def one(params, acts, lam):
        out = loss_fn(params, *acts, lam)
        dead, sparsity, _ = metrics.measure_inactive_units(out["encoded"], expansion_factor)
        return out["loss"], (out["rec_loss"], out["l1_loss"], dead, sparsity)

    batched = torch.func.vmap(torch.func.grad_and_value(one, has_aux=True),
                              in_dims=(0, None, 0))

    def loss(params, *acts_and_lams):
        *acts, lams = acts_and_lams
        # a bf16 cache's activations in f32, as JAX promotes them against f32 weights
        acts = tuple(a.float() for a in acts)
        grads, (value, (rec, l1, dead, sparsity)) = batched(params, acts, lams)
        return {"grads": grads, "loss": value, "rec_loss": rec, "l1_loss": l1, "dead": dead,
                "sparsity": sparsity}

    return loss


def _make_sweep_step(loss, lams, tx: optim.Optimizer, dead_neurons_steps: int, resample,
                     gives_grads: bool):
    """The sweep's update around ``loss(params, *acts, lambdas)``: its terms
    carry "grads" (``gives_grads``: the stock vmap) or are differentiated here
    (a fused sweep op: the sum of the [N] losses). ``resample(params_n, opt_n, dead_n, rng_n,
    draws_n)`` is the per-combo resample (None: the rolling dead window).
    ``step_fn(ss, *acts, resample_draws=None) -> (ss, metrics of [N])``;
    ``resample_draws`` holds each combo's draws (tests inject the JAX
    package's)."""

    def step_fn(ss: SweepState, *acts, resample_draws=None):
        if gives_grads:
            out = loss(ss.params, *acts, lams)
            grads = out["grads"]
        else:
            keys = list(ss.params)
            params = {k: v.detach().requires_grad_(True) for k, v in ss.params.items()}
            out = loss(params, *acts, lams)
            gs = torch.autograd.grad(out["loss"].sum(), [params[k] for k in keys],
                                     allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(keys, gs)}
        with torch.no_grad():
            updates, opt_state = tx.update(grads, ss.opt_state, ss.params)
            new_params = optim.apply_updates(ss.params, updates)
            step = ss.step + 1
            dead_acc = ss.dead_acc & out["dead"]
            # read before the reset or resample, as JAX's sweep reads it inside
            # the vmapped update (its single-device step reads it after)
            perc_dead = dead_acc.sum(1) / dead_acc.shape[1]
            if resample is None:
                if step % dead_neurons_steps == 0:  # the rolling dead window
                    dead_acc = torch.ones_like(dead_acc)
            elif should_resample(step, dead_neurons_steps):
                new_params, opt_state = _resample_combos(
                    resample, new_params, opt_state, dead_acc, ss.rngs, resample_draws)
                dead_acc = torch.ones_like(dead_acc)
            elif should_reset_measurement(step, dead_neurons_steps):
                dead_acc = torch.ones_like(dead_acc)
            m = {"sae_loss": out["loss"].detach(), "sae_rec_loss": out["rec_loss"].detach(),
                 "sae_l1_loss": out["l1_loss"].detach(), "sparsity": out["sparsity"].detach(),
                 "perc_dead": perc_dead}
        return SweepState(new_params, opt_state, step, dead_acc, ss.rngs), m

    return step_fn


def _resample_combos(resample, params, opt_state, dead_acc, rngs, draws):
    """``resample`` per combo on its slices, its generator and (given) its
    draws; the results restacked."""
    outs = [resample(_slice(params, i), _slice(opt_state, i), dead_acc[i], rngs[i],
                     None if draws is None else draws[i]) for i in range(len(rngs))]
    return _stack([p for p, _ in outs]), _stack([o for _, o in outs])


def make_sae_sweep_step(sae_model_name: str, lambdas: Sequence[float],
                        learning_rates: Sequence[float], optimizer_name: str,
                        dead_neurons_steps: int, expansion_factor: int, topk: int = 32,
                        topk_approx: bool = False,
                        jumprelu_bandwidth: float = JUMPRELU_BANDWIDTH,
                        matryoshka_prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES,
                        fused: bool = False, fused_opts: Optional[dict] = None,
                        device=None):
    """The N-combo step: ``step_fn(ss, act [T, C], resample_draws=None) ->
    (ss, metrics dict of [N] tensors)``. Per combo the math of
    train/steps.make_sae_train_step_from_acts; ``fused=True`` runs the
    variant's sweep op (one forward and one backward launch for all combos on
    the card, the plain versions on the CPU), else the stock math under
    torch.func.vmap (module docstring). ``fused_opts`` may set
    ``compute_dtype``, and ``bandwidth`` for jumprelu_sae. ``device`` is the
    parameters' (where the [N] λ and learning rates live; default the CPU)."""
    lams, lrs = _hyper(lambdas, learning_rates, device)
    loss = fused_loss = _fused_sweep_loss(sae_model_name, expansion_factor,
                                          matryoshka_prefixes,
                                          fused_opts or {}) if fused else None
    if loss is None:
        def model_loss(params, act, lam):
            return sae_inference_and_loss(sae_model_name, params, act, lam, topk=topk,
                                          topk_approx=topk_approx,
                                          jumprelu_bandwidth=jumprelu_bandwidth,
                                          matryoshka_prefixes=matryoshka_prefixes)

        loss = _vmapped_loss(model_loss, expansion_factor)
    return _make_sweep_step(loss, lams, optim.get_optimizer(optimizer_name, lrs),
                            dead_neurons_steps,
                            resample_sae if sae_model_name == "sae_mlp" else None,
                            gives_grads=fused_loss is None)


def make_transcoder_sweep_step(lambdas: Sequence[float], learning_rates: Sequence[float],
                               optimizer_name: str, dead_neurons_steps: int,
                               expansion_factor: int, device=None):
    """Transcoder twin of make_sae_sweep_step: ``step_fn(ss, x [T, d_in], y [T,
    d_out], resample_draws=None)``; N combos share one paired activation
    stream, each resampling like sae_mlp (the rectangular decoder's
    surgery). ``device`` as make_sae_sweep_step's."""
    lams, lrs = _hyper(lambdas, learning_rates, device)
    loss = _vmapped_loss(transcoder_inference_and_loss, expansion_factor)
    return _make_sweep_step(loss, lams, optim.get_optimizer(optimizer_name, lrs),
                            dead_neurons_steps, resample_sae, gives_grads=True)


def make_crosscoder_sweep_step(lambdas: Sequence[float], learning_rates: Sequence[float],
                               optimizer_name: str, dead_neurons_steps: int,
                               expansion_factor: int, device=None):
    """Crosscoder twin of make_sae_sweep_step: ``step_fn(ss, xs tuple of [T, d_l],
    resample_draws=None)``; N combos share one tuple of aligned activation
    streams; each combo resamples with the multi-layer surgery
    (train/crosscoder.py). ``device`` as make_sae_sweep_step's."""
    from sparse_vision_tpu_torch.models.crosscoder import crosscoder_inference_and_loss
    from sparse_vision_tpu_torch.train.crosscoder import _resample

    if optimizer_name == "constrained_adam":
        raise ValueError("crosscoders need a plain optimizer (train/crosscoder.py): "
                         "ConstrainedAdam would erase the decoder-norm diffing signal")
    lams, lrs = _hyper(lambdas, learning_rates, device)
    loss = _vmapped_loss(lambda params, *xs_and_lam: crosscoder_inference_and_loss(
        params, tuple(xs_and_lam[:-1]), xs_and_lam[-1]), expansion_factor)
    inner = _make_sweep_step(loss, lams, optim.get_optimizer(optimizer_name, lrs),
                             dead_neurons_steps, _resample, gives_grads=True)

    def step_fn(ss: SweepState, xs: tuple, resample_draws=None):
        return inner(ss, *xs, resample_draws=resample_draws)

    return step_fn


def group_sweepable(cfgs: Sequence[RunConfig]) -> tuple:
    """Partition sweep-file entries into vmappable groups and leftovers:
    ``([(base_cfg, overrides), ...], [cfg, ...])``. Entries that differ ONLY
    in SWEEPABLE_FIELDS and are cached dictionary-training runs (use_sae,
    training, use_activation_cache, no dump/train overlap, no MIS or IE) group
    into one sweep; everything else, and singleton groups, run one by one.
    File order is kept within and across groups."""
    from sparse_vision_tpu_torch.utils.paths import sae_params_no_epochs

    buckets: dict = {}
    for cfg in cfgs:
        d = json.loads(cfg.to_json())
        for f in SWEEPABLE_FIELDS:
            d.pop(f, None)
        buckets.setdefault(json.dumps(d, sort_keys=True), []).append(cfg)
    groups, singles = [], []
    for members in buckets.values():
        base = members[0]
        # run identities exclude the seed (the reference's parameter strings),
        # so combos that differ in seed alone collide: they run one by one,
        # overwriting each other's artifacts as the reference's would
        identities = [(c.sae_layer, tuple(sae_params_no_epochs(c).values())) for c in members]
        eligible = (
            len(members) >= 2
            and len(set(identities)) == len(identities)
            and base.use_sae and base.training and base.use_activation_cache
            and not base.overlap_dump_train and base.mis == "0" and base.compute_ie == "0"
            and not (base.sae_model_name in ("transcoder", "crosscoder") and base.mesh_shape)
            and base.sae_model_name != "batch_topk_sae"
        )
        if eligible:
            groups.append((base, [{f: getattr(c, f) for f in SWEEPABLE_FIELDS}
                                  for c in members]))
        else:
            singles.extend(members)
    return groups, singles


def _validate_overrides(base_cfg: RunConfig, overrides: Sequence[dict]) -> None:
    if not overrides:
        raise ValueError("Need at least one sweep combo")
    for i, ov in enumerate(overrides):
        bad = set(ov) - set(SWEEPABLE_FIELDS)
        if bad:
            raise ValueError(
                f"Combo {i} overrides non-sweepable fields {sorted(bad)}; a vmapped sweep can "
                f"only vary {SWEEPABLE_FIELDS} (run differing combos as separate pipelines)")
    if not (base_cfg.use_sae and base_cfg.training):
        raise ValueError("Vmapped sweeps train SAEs: need use_sae=True, training=True")
    if base_cfg.overlap_dump_train:
        raise ValueError("overlap_dump_train is not supported in vmapped sweeps (the shared "
                         "cache is dumped once, sequentially, before training)")


def _check_one_rank(base_cfg: RunConfig) -> None:
    if math.prod(base_cfg.mesh_shape) > 1 or (torch.distributed.is_available()
                                              and torch.distributed.is_initialized()
                                              and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            f"a vmapped sweep runs on one rank (mesh_shape={base_cfg.mesh_shape}): the JAX "
            "package's 'data'-mesh sweep is not ported (ROADMAP A6); run the combos "
            "one by one on the mesh")
    if base_cfg.sae_e2e_finetune_epochs > 0:
        raise NotImplementedError("a vmapped sweep runs no e2e finetune (as the JAX "
                                  "package's); run finetuned combos one by one")


def _pipelines(base_cfg: RunConfig, overrides, datasets, device, pipelines) -> list:
    """One Pipeline per combo on the first combo's backbone and datasets, with
    the duplicate and resume checks; ``pipelines`` (a list) receives them."""
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    _validate_overrides(base_cfg, overrides)
    _check_one_rank(base_cfg)
    pipes = [] if pipelines is None else pipelines
    for ov in overrides:
        cfg = dataclasses.replace(base_cfg, **{**ov, "use_activation_cache": True,
                                               "training": True})
        p = Pipeline(cfg, device=device, datasets=datasets)
        if datasets is None:
            datasets = (p.train_ds, p.val_ds, p.category_names, p.img_size)
        if pipes:
            # one backbone for the whole sweep: the cache is dumped from the first
            # combo's frozen model, so every combo evaluates against it too
            p.frozen_params, p.net_state = pipes[0].frozen_params, pipes[0].net_state
            p._model_ckpt_epoch = pipes[0]._model_ckpt_epoch
        pipes.append(p)
    dirs = [p._sae_ckpt_dir() for p in pipes]
    if len(set(dirs)) != len(dirs):
        raise ValueError("Duplicate sweep combos (identical run identities)")
    starts = {p.cfg.sae_checkpoint_epoch for p in pipes}
    if len(starts) != 1:
        raise ValueError(f"Combos disagree on sae_checkpoint_epoch: {sorted(starts)}")
    return pipes


def _train(pipes: list, step_fn, epoch_stacks, cfg: RunConfig, after=None) -> list:
    """The sweep's epochs: the pre-training evals, then per epoch every stack
    that ``epoch_stacks(epoch)`` yields (a tuple of [k, T, C_l] stacks, staged
    onto the device through data/prefetch.py) step by step through ``step_fn``,
    each combo's log and train_log fed its own row, the epoch's timing,
    then each combo's asynchronous checkpoint and eval. Then wait for the
    checkpoints, export every combo's weights and call ``after(pipe)``.
    Returns the combos' last eval means."""
    from sparse_vision_tpu_torch.data.prefetch import prefetch
    from sparse_vision_tpu_torch.train import checkpoint as ckpt

    p0 = pipes[0]
    ss = stack_sae_states([p.ts for p in pipes])
    start = cfg.sae_checkpoint_epoch
    last = [None] * len(pipes)
    for p in pipes:  # the pre-training eval
        p.eval_modified(epoch=start, store=False)
    for epoch in range(start, cfg.sae_epochs):
        t0 = time.perf_counter()
        step0 = ss.step
        for stacks in prefetch(epoch_stacks(epoch), p0.device):
            ms = []
            for acts in zip(*stacks):
                ss, m = step_fn(ss, *acts)
                ms.append((ss.step, m))
            for i, p in enumerate(pipes):  # the last step of each dispatch, as JAX logs
                rows = [(s, {k: v[i] for k, v in m.items()}) for s, m in ms]
                p.logger.log_train(*rows[-1])
                p.train_log.extend(rows)
        if p0.device.type == "cuda":
            torch.cuda.synchronize(p0.device)
        seconds = time.perf_counter() - t0
        for i, p in enumerate(pipes):
            p.ts = unstack_sae_state(ss, i)
            p.train_timing.append({"epoch": epoch, "steps": ss.step - step0,
                                   "tokens": (ss.step - step0) * cfg.cache_tokens_per_step,
                                   "combos": len(pipes), "seconds": seconds})
            ckpt.save_checkpoint(p._sae_ckpt_dir(), epoch + 1, p._ckpt_tree(), blocking=False)
            last[i] = p.eval_modified(epoch=epoch + 1, final=epoch + 1 == cfg.sae_epochs)
    ckpt.wait_for_saves()
    for p in pipes:
        p._export_sae_weights()
        if after is not None:
            after(p)
    return last


def train_sae_sweep_cached(base_cfg: RunConfig, overrides: Sequence[dict], datasets=None,
                           device=None, pipelines: Optional[list] = None) -> list:
    """Train one dictionary per combo (``overrides``: dicts of SWEEPABLE_FIELDS),
    all in one step off one activation cache. Each combo's artifacts
    (per-epoch checkpoints, eval rows, weight exports) come from its own
    Pipeline as an individual train_sae_cached run's would; only the train
    step is batched. Returns the combos' final eval means, in override order.
    ``device`` and ``datasets`` are Pipeline's; ``pipelines`` (a list)
    receives the combos' Pipelines. The transcoder and crosscoder go to their
    twins. The fused sweep op runs where ``use_pallas`` says, as in
    train_sae_cached (Pipeline.check_fusable raises on the card for a shape
    the kernels refuse)."""
    from sparse_vision_tpu_torch.data.activation_cache import ActivationCache, dump_activations
    from sparse_vision_tpu_torch.train.steps import fused_op

    if base_cfg.sae_model_name == "transcoder":
        return train_transcoder_sweep_cached(base_cfg, overrides, datasets, device, pipelines)
    if base_cfg.sae_model_name == "crosscoder":
        return train_crosscoder_sweep_cached(base_cfg, overrides, datasets, device, pipelines)
    if base_cfg.sae_model_name == "batch_topk_sae":
        raise ValueError("batch_topk_sae is not vmap-sweepable (the inference-threshold EMA "
                         "is per-run state); run combos individually")
    pipes = _pipelines(base_cfg, overrides, datasets, device, pipelines)
    p0, cfg = pipes[0], base_cfg
    cache_dir = p0._cache_dir(cfg.sae_layer)
    if not os.path.exists(os.path.join(cache_dir, "meta.json")):
        print(f"Building activation cache at {cache_dir} ...")
        dump_activations(p0.net, p0.frozen_params, p0.net_state, p0.train_ds, cfg.sae_layer,
                         cache_dir, device=p0.device, **p0._cache_dump_kwargs())
    cache = ActivationCache(cache_dir)

    if cfg.sae_model_name == "topk_sae":
        fused = cfg.use_pallas
    else:
        can_fuse, _ = fused_op(cfg.sae_model_name, cfg.matryoshka_prefix_fractions)
        c = p0.sae_input_size
        fused = p0.check_fusable(lambda t, h, c_in, _, dtype: can_fuse(t, h, c_in, dtype), c, c)
    fused_opts = {"compute_dtype": cfg.compute_dtype}
    if cfg.sae_model_name == "jumprelu_sae":
        fused_opts["bandwidth"] = cfg.jumprelu_bandwidth
    step_fn = make_sae_sweep_step(
        cfg.sae_model_name, [p.cfg.sae_lambda_sparse for p in pipes],
        [p.cfg.sae_learning_rate for p in pipes], cfg.sae_optimizer_name,
        cfg.dead_neurons_steps, cfg.sae_expansion_factor, topk=cfg.sae_topk,
        topk_approx=cfg.sae_topk_approx, jumprelu_bandwidth=cfg.jumprelu_bandwidth,
        matryoshka_prefixes=cfg.matryoshka_prefix_fractions, fused=fused,
        fused_opts=fused_opts, device=p0.device)
    step_fn = p0.normalized_step(step_fn, (cfg.sae_layer,))

    def epoch_stacks(epoch):
        return ((s,) for s in cache.stacks(cfg.cache_tokens_per_step, p0.CACHE_SCAN_K,
                                           shuffle=True, seed=cfg.seed + epoch))

    return _train(pipes, step_fn, epoch_stacks, cfg)


def train_transcoder_sweep_cached(base_cfg: RunConfig, overrides: Sequence[dict],
                                  datasets=None, device=None,
                                  pipelines: Optional[list] = None) -> list:
    """Transcoder sweep: N (λ, lr, seed) combos of one sae_layer ->
    transcoder_target_layer dictionary in one step off the shared paired
    caches (train/paired_caches.py dumps both layers in one backbone pass).
    Artifacts per combo as individual runs'."""
    from sparse_vision_tpu_torch.train.paired_caches import prepare_caches

    if not base_cfg.transcoder_target_layer:
        raise ValueError("transcoder sweeps need transcoder_target_layer set")
    pipes = _pipelines(base_cfg, overrides, datasets, device, pipelines)
    p0, cfg = pipes[0], base_cfg
    layers = (cfg.sae_layer, cfg.transcoder_target_layer)
    _, _, caches = prepare_caches(p0, layers, {l: p0._cache_dir(l) for l in layers})
    step_fn = make_transcoder_sweep_step(
        [p.cfg.sae_lambda_sparse for p in pipes], [p.cfg.sae_learning_rate for p in pipes],
        cfg.sae_optimizer_name, cfg.dead_neurons_steps, cfg.sae_expansion_factor,
        device=p0.device)
    return _train(pipes, p0.normalized_step(step_fn, layers),
                  _zipped(caches, cfg, p0.CACHE_SCAN_K), cfg)


def _zipped(caches: list, cfg: RunConfig, k: int):
    """``epoch_stacks`` of aligned caches: their shuffled readers zipped under
    one seed, which visit the same token rows."""
    def epoch_stacks(epoch):
        return zip(*(c.stacks(cfg.cache_tokens_per_step, k, shuffle=True, seed=cfg.seed + epoch)
                     for c in caches))

    return epoch_stacks


def train_crosscoder_sweep_cached(base_cfg: RunConfig, overrides: Sequence[dict],
                                  datasets=None, device=None,
                                  pipelines: Optional[list] = None) -> list:
    """Crosscoder sweep: N (λ, lr, seed) combos of one L-layer crosscoder in one
    step off the shared aligned caches, each combo with its decoder-norm
    diffing CSV in its run's sae_weights folder."""
    from sparse_vision_tpu_torch.train.crosscoder import save_decoder_norms
    from sparse_vision_tpu_torch.train.paired_caches import prepare_caches
    from sparse_vision_tpu_torch.utils.paths import sae_run_name

    pipes = _pipelines(base_cfg, overrides, datasets, device, pipelines)
    p0, cfg = pipes[0], base_cfg
    layers = p0.crosscoder_all_layers
    # always the sequential dump: _validate_overrides refuses overlap_dump_train
    _, _, caches = prepare_caches(p0, layers, {l: p0._cache_dir(l) for l in layers})
    step_fn = make_crosscoder_sweep_step(
        [p.cfg.sae_lambda_sparse for p in pipes], [p.cfg.sae_learning_rate for p in pipes],
        cfg.sae_optimizer_name, cfg.dead_neurons_steps, cfg.sae_expansion_factor,
        device=p0.device)
    normalized = p0.normalized_step(lambda ss, *xs: step_fn(ss, xs), layers)

    def norms(p):
        p.decoder_norms_path = save_decoder_norms(p.ts.params, layers, p.paths["sae_weights"],
                                                  sae_run_name(p.cfg))

    return _train(pipes, normalized, _zipped(caches, cfg, p0.CACHE_SCAN_K), cfg, after=norms)
